"""Operations and bytes of one ``swin_attn_block`` call (Swin's window
attention half-block over windows of ``n`` tokens): LayerNorm, qkv, scores
plus the relative-position addend and the shift mask, softmax, P.V, proj
and the residual.  Operations: qkv and proj, 2 * rows * 4 C^2, and the
scores and P.V, 2 * 2 * rows * n * C.  Bytes: the stream in and out, the two
weights, their int32 biases and f32 multipliers, the LN's multiplier and
integer bias, the f32 relative-position addend [heads, n, n] and, on a
shifted block, the f32 mask [windows, n, n]."""


def calls(blocks):
    out = []
    for b in blocks:
        if b["attn"] != "swin_attn_block":
            continue
        rows, C, n = b["seqs"] * b["n"], b["dim"], b["n"]
        ops = 2 * rows * 4 * C * C + 2 * 2 * rows * n * C
        nbytes = (rows * C * (b["attn_in"] + b["attn_out"]) + 4 * C * C
                  + 4 * 4 * C + 4 * 4 * C + 4 * 2 * C
                  + 4 * b["heads"] * n * n + 4 * b["masked"] * n * n)
        out.append((ops, nbytes))
    return out
