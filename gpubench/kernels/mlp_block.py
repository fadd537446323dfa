"""Operations and bytes of one ``mlp_block`` call: LayerNorm, fc1, GELU,
fc2 and the residual over ``rows`` token rows of width C (hidden H).
Operations: the two GEMMs, 2 * rows * C * H each.  Bytes: the stream in
and out, both weights, their int32 biases and f32 multipliers, the LN's
multiplier and integer bias."""


def calls(blocks):
    out = []
    for b in blocks:
        rows, C, H = b["seqs"] * b["n"], b["dim"], b["hidden"]
        ops = 2 * rows * C * H * 2
        nbytes = (rows * C * (b["mlp_in"] + b["mlp_out"]) + 2 * C * H
                  + 4 * (H + C) + 4 * (H + C) + 4 * 2 * C)
        out.append((ops, nbytes))
    return out
