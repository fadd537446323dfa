"""Operations and bytes of one ``attn_block`` call (a ViT's attention
half-block over whole sequences of ``n`` tokens): LayerNorm, qkv, scores,
softmax, P.V, proj and the residual.  Operations: qkv and proj, 2 * rows *
4 C^2, and the scores and P.V, 2 * 2 * seqs * n^2 * C.  Bytes: the stream in
and out, the two weights, their int32 biases and f32 multipliers, the LN's
multiplier and integer bias."""


def calls(blocks):
    out = []
    for b in blocks:
        if b["attn"] != "attn_block":
            continue
        rows, C = b["seqs"] * b["n"], b["dim"]
        ops = 2 * rows * 4 * C * C + 2 * 2 * b["seqs"] * b["n"] ** 2 * C
        nbytes = (rows * C * (b["attn_in"] + b["attn_out"]) + 4 * C * C
                  + 4 * 4 * C + 4 * 4 * C + 4 * 2 * C)
        out.append((ops, nbytes))
    return out
