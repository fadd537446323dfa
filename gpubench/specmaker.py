"""Seeded integer engine specs at a configuration's own widths: the
benchmark's frozen copy of the arithmetic of a freeze.

A spec is the tree a freeze of a calibrated W8A8 ViT or Swin writes: int8
weights quantized per output column from a normal draw, int32 biases on the
``w_scale * s_in`` grid, one f32 requant multiplier per edge (a correctly
rounded ratio of two scales), the LayerNorms' integer biases, the frozen
gates (``fast_exp``, ``fast_poly``, ``sm_sum_i32``) and, as a freeze writes
them, each block's 256-entry tables with ``use_lut``.  The site scales are
set from the fan-in so that every int8 requant spreads over about 32 LSB
and saturates rarely, and the nonlinearities' input scales are ones that a
calibrated DeiT-S gives: a spec that is neither dead nor saturated, so an
exact comparison of logits means something.  The ivit and ibert softmax,
GELU and LayerNorm families are made here.

The draws are numpy's ``default_rng(seed)`` in one fixed order, so a seed
always gives the same tree.  Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import intops as io

# nonlinearity input scales read off a calibrated DeiT-S (entry i % 2 of
# block i): the ibert softmax and GELU, the ivit GELU; the ivit softmax takes
# the scales at which a trained model's peaked attention spans +-6.6 / +-7.7
S_ATTN = {"ibert": (0.005533343, 0.0049191364), "ivit": (0.0521371, 0.061)}
S_GELU = {"ibert": (0.013059441, 0.013524539), "ivit": (0.014047618, 0.014301606)}
SIGMA = 4.0          # calibrated range in standard deviations
W_STD = 0.02         # weight draw before the per-column int8 quant
SCORE_SPREAD = 40.0  # int8 score spread the qkv weights aim for
CTX_GAIN = {("ibert", 8): 0.018, ("ivit", 8): 0.3,
            ("ibert", 16): 0.19, ("ivit", 16): 0.33}
SWIN_S_ATTN1_RATIO = 0.75
SWIN_REL_GAIN = 0.5
SWIN_CTX_GAIN = {"ibert": 0.15, "ivit": 0.3}
BIT_KEYS = ("patch_embed", "pos_encoding", "block_input", "attention_out",
            "softmax", "mlp_out", "norm2_in", "att_block_out")
F32_EPS = float(np.finfo(np.float32).eps)


def bits(spec) -> dict:
    """The 8-position bitwidth vector from ``"8"`` or ``"8,8,8,8,16,8,16,8"``."""
    parts = [int(p) for p in str(spec).split(",")]
    return dict(zip(BIT_KEYS, parts * 8 if len(parts) == 1 else parts))


def _sym_scale(num_bits, x_min, x_max):
    n = np.float32(2 ** (num_bits - 1) - 1)
    mag = np.maximum(-np.asarray(x_min).astype(np.float32),
                     np.asarray(x_max).astype(np.float32))
    return np.maximum(mag / n, np.float32(F32_EPS))


def _quant(w, num_bits, scale):
    n = 2 ** (num_bits - 1) - 1
    return np.clip(np.round(np.asarray(w).astype(np.float32) / scale), -n - 1, n)


def multiplier(s_in, s_out):
    return (np.asarray(s_in).astype(np.float32)
            / np.asarray(s_out).astype(np.float32)).astype(np.float32)


def _const(z, s_in, s_out):
    return np.round(np.asarray(z).astype(np.float32) * multiplier(s_in, s_out))


def _scale(std, nbits=8):
    return _sym_scale(nbits, np.float32(-SIGMA * std), np.float32(SIGMA * std))


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v) for v in t]
    a = np.asarray(t, order="C")
    return a if a.dtype in (np.int8, np.int32) else a.astype(np.float32)


class _Sites:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def linear(self, fan_in, fan_out, s_in, in_std, w_std=W_STD):
        w = self.rng.normal(0.0, w_std, (fan_in, fan_out)).astype(np.float32)
        w_scale = _sym_scale(8, w.min(axis=0), w.max(axis=0))
        w_int = _quant(w, 8, w_scale[None, :]).astype(np.int8)
        b_scale = (w_scale.astype(np.float64) * np.float64(s_in)).astype(np.float32)
        out_std = float(np.sqrt(fan_in) * in_std * w_std)
        b = self.rng.normal(0.0, 0.1 * out_std, fan_out).astype(np.float32)
        return w_int, _quant(b, 32, b_scale).astype(np.int32), b_scale, out_std

    def layernorm(self, dim, shift=0.0):
        gamma = self.rng.uniform(0.8, 1.2, dim).astype(np.float32)
        beta = self.rng.normal(0.0, 0.1, dim).astype(np.float32)
        base = np.float32(np.sqrt(dim) / 2.0**30)
        return (np.floor((beta / gamma) / base).astype(np.float32), base * gamma,
                np.float32(shift))


def ibert_ln_shift(dim, nbits):
    """The overflow shift calibration gives an ibert LayerNorm over ``dim``
    channels of an ``nbits`` stream spread to +-SIGMA deviations."""
    var = dim * (2.0 ** (nbits - 1) / SIGMA) ** 2
    return float(max(0.0, np.ceil(np.log2(np.sqrt(var / 2.0**32)))))


def _fastdiv_ok(x0, n):
    x0 = float(x0)
    return x0 < 0 and np.isfinite(x0) and -x0 <= 2.0 ** (23 - int(np.floor(np.log2(n))))


def _exp_fast_gate(sm, ge, s_attn, s_gelu):
    ok = True
    if sm == "ivit":
        ok = ok and _fastdiv_ok(np.floor(np.float32(-1.0) / np.float32(s_attn)), 15)
    else:
        ok = ok and _fastdiv_ok(np.floor(np.float32(io.EXP_X0) / np.float32(s_attn)),
                                io.EXP_N)
    if ge == "ivit":
        s_sig = np.float32(np.float32(s_gelu) * np.float32(1.702))
        ok = ok and _fastdiv_ok(np.floor(np.float32(-1.0) / s_sig), 23)
    return bool(ok)


def _poly_fast_gate(sm, ge, s_attn, s_gelu):
    lim, ok = 2.0**24, True
    if sm == "ibert":
        s = np.float32(s_attn)
        x0 = abs(np.floor(np.float32(io.EXP_X0) / s))
        b = np.floor(np.float32(io.EXP_B) / s)
        c = abs(np.floor(np.float32(io.EXP_C) / np.float32(s * s)))
        ok = ok and bool(x0 * (x0 + abs(b)) + c < lim)
    if ge == "ibert":
        se = np.float32(np.float32(s_gelu) / np.float32(io.GELU_K))
        b = abs(np.floor(np.float32(io.GELU_B) / se))
        c = abs(np.floor(np.float32(io.GELU_C) / np.float32(se * se)))
        ok = ok and bool(b * b + c < lim)
    return bool(ok)


def _gelu_out_scale(ge, s_g):
    if ge == "ivit":
        return np.float32(s_g) / np.float32(2.0**7)
    sk = np.float32(np.float32(s_g) / np.float32(io.GELU_K))
    sig = np.float32(np.float32(np.float32(sk * sk) * np.float32(io.GELU_A))
                     * np.float32(2.0**io.GELU_N))
    return np.float32(np.float32(np.float32(s_g) * sig) / np.float32(2.0))


# --- the freeze's tables -------------------------------------------------------

def _t(x):
    return torch.as_tensor(np.float32(x))


def _np(t):
    return t.numpy().astype(np.float32)


_DIFFS = -torch.arange(256, dtype=torch.float32)
_INT8 = torch.arange(256, dtype=torch.float32) - 128.0


def _sm_lut(sm, blk):
    if sm == "ivit":
        return _np(io.shift_exp(_DIFFS, _t(blk["s_attn"]), 15))
    e = io.ibert_exp(_DIFFS, _t(blk["s_attn"]))
    m = io.rdiv(1.0, _t(blk["s_exp_act"]))
    return _np(torch.clamp(torch.round(e * m), -(2.0**15), 2.0**15 - 1))


def _gelu_lut(ge, s_gelu):
    if ge == "ivit":
        return _np(io.shift_exp(_DIFFS, _t(s_gelu) * 1.702, 23))
    erf, sig_scale = io.ibert_erf(_INT8, io.rdiv(_t(s_gelu), io.GELU_K))
    return _np(erf + torch.floor(io.rdiv(1.0, sig_scale)))


def _sum_fits_int32(lut, n):
    return bool(n * (float(np.max(np.abs(lut))) if lut.size else 0.0) < 2.0**31)


def _shift_sat(sm, blk):
    m = abs(float(blk["mask_int"].min()))
    d = -torch.arange(max(0.0, m - 255.0), m + 256.0, dtype=torch.float32)
    if sm == "ivit":
        v = io.shift_exp(d, _t(blk["s_attn"]), 15)
    else:
        v = torch.clamp(torch.round(io.ibert_exp(d, _t(blk["s_attn"]))
                                    * io.rdiv(1.0, _t(blk["s_exp_act"]))),
                        -(2.0**15), 2.0**15 - 1)
    v = _np(v)
    ok = bool(v.size > 0 and np.all(v == v[0]))
    return ok, (v[0] if ok else np.float32(0.0))


def with_tables(cfg, params, n_softmax):
    """Each block's ``sm_lut`` and ``gelu_lut`` (``sm_sat`` on a shifted Swin
    block whose masked exps saturate), ``use_lut`` and the ``sm_sum_i32``
    gate, as a freeze writes them; ``n_softmax(entry)`` is the softmax row
    length of a block."""
    sm, ge = cfg["softmax_type"], cfg["gelu_type"]
    sum_i32, blocks = cfg["sm_sum_i32"], []
    layout = cfg.get("layout") or [("block", 0, 0)] * len(params["blocks"])
    for entry, blk in zip(layout, params["blocks"]):
        blk = dict(blk)
        if entry[0] == "block":
            blk["sm_lut"] = _sm_lut(sm, blk)
            if sm == "ivit":
                sum_i32 = sum_i32 and _sum_fits_int32(blk["sm_lut"], n_softmax(entry))
            blk["gelu_lut"] = _gelu_lut(ge, blk["s_gelu"])
            if entry[2] > 0:
                ok, sat = _shift_sat(sm, blk)
                if ok:
                    blk["sm_sat"] = sat
        blocks.append(blk)
    cfg = {**cfg, "use_lut": True, "sm_sum_i32": sum_i32}
    return cfg, {**params, "blocks": blocks}


# --- ViT / DeiT ----------------------------------------------------------------

def _families(cfg):
    fam = (cfg["softmax_type"], cfg["gelu_type"], cfg["layernorm_type"])
    if not all(f in ("ivit", "ibert") for f in fam):
        raise NotImplementedError(f"the spec maker makes the ivit and ibert "
                                  f"families; got {fam}")
    return fam


def vit_spec(cfg, seed):
    """(cfg with the freeze's flags and ``bits``, numpy spec tree)."""
    sm, ge, ln = _families(cfg)
    bw = bits(cfg["bitwidths"])
    C, H = cfg["embed_dim"], cfg["num_heads"]
    hidden = int(C * cfg["mlp_ratio"])
    grid = cfg["img_size"] // cfg["patch_size"]
    n_tok = grid * grid + 1
    attn_scale = np.float32((C // H) ** -0.5)
    site = _Sites(seed)
    p = {}

    def ln_site(nbits):
        return site.layernorm(C, ibert_ln_shift(C, nbits) if ln == "ibert" else 0.0)

    s_input = _scale(1.0)
    p["s_input"] = s_input
    w, b, s_conv, patch_std = site.linear(cfg["patch_size"] ** 2 * 3, C, s_input, 1.0)
    s_patch = _scale(patch_std, bw["patch_embed"])
    p["patch"] = {"w": w, "b": b, "m": multiplier(s_conv, s_patch)}
    p["s_patch"] = s_patch
    cls = site.rng.normal(0.0, patch_std, (1, 1, C)).astype(np.float32)
    p["cls_int"] = np.round(cls / s_patch)
    pos_std = patch_std / 2
    s_pos = _scale(pos_std, bw["pos_encoding"])
    pos = site.rng.normal(0.0, pos_std, (1, n_tok, C)).astype(np.float32)
    pos_int = _quant(pos, bw["pos_encoding"], s_pos)
    x_std = float(np.hypot(patch_std, pos_std))
    s_in = _scale(x_std, bw["block_input"])
    p["pos_addend"] = _const(pos_int, s_pos, s_in).astype(np.float32)
    p["m_x0"] = multiplier(s_patch, s_in)
    p["s_block0"] = s_in

    fast_exp = fast_poly = sum_i32 = True
    blocks, x_bits = [], bw["block_input"]
    for i in range(cfg["depth"]):
        s_attn = np.float32(S_ATTN[sm][i % 2])
        s_g = np.float32(S_GELU[ge][i % 2])
        blk = {}
        lb, ls, lsh = ln_site(x_bits)
        s_a1 = _scale(1.0)
        blk.update(ln1_bias_int=lb, ln1_shift=lsh, s_ln1=ls, m_ln1=multiplier(ls, s_a1))
        q_std = float(np.sqrt(SCORE_SPREAD * s_attn))
        w, b, s_qkv, q_std = site.linear(C, 3 * C, s_a1, 1.0, w_std=q_std / np.sqrt(C))
        s_q = _scale(q_std)
        blk.update(qkv_w=w, qkv_b=b, m_qkv=multiplier(s_qkv, s_q))
        s_scores = np.float32(np.float32(s_q * s_q) * attn_scale)
        blk["m_attn"] = multiplier(s_scores, s_attn)
        blk["s_attn"] = s_attn
        if sm == "ibert":
            c_int = np.floor(np.float32(io.EXP_C) / np.float32(s_attn * s_attn))
            blk["s_exp_act"] = _sym_scale(16, np.float32(0.0), np.float32(c_int * 2.0**30))
            s_sm = np.float32(2.0 / 2 ** bw["softmax"])
        else:
            s_sm = np.float32(1.0 / 2 ** (bw["softmax"] - 1))
            sum_i32 = sum_i32 and _sum_fits_int32(
                _np(io.shift_exp(_DIFFS, _t(s_attn), 15)), n_tok)
        ctx_std = CTX_GAIN[sm, bw["softmax"]] * q_std
        s_a2 = _scale(ctx_std)
        blk["m_av"] = multiplier(np.float32(s_sm * s_q), s_a2)
        w, b, s_pj, proj_std = site.linear(C, C, s_a2, ctx_std)
        s_a3 = _scale(proj_std, bw["attention_out"])
        blk.update(proj_w=w, proj_b=b, m_proj=multiplier(s_pj, s_a3))
        res1_std = float(np.hypot(proj_std, x_std))
        s_res1 = _scale(res1_std, bw["norm2_in"])
        blk["m_res1_x"] = multiplier(s_a3, s_res1)
        blk["m_res1_id"] = multiplier(s_in, s_res1)

        lb, ls, lsh = ln_site(bw["norm2_in"])
        s_m1 = _scale(1.0)
        blk.update(ln2_bias_int=lb, ln2_shift=lsh, s_ln2=ls, m_ln2=multiplier(ls, s_m1))
        h_std = float(s_g) * 127.0 / SIGMA
        w, b, s_fc1, h_std = site.linear(C, hidden, s_m1, 1.0, w_std=h_std / np.sqrt(C))
        blk.update(fc1_w=w, fc1_b=b, m_fc1=multiplier(s_fc1, s_g), s_gelu=s_g)
        g_std = 0.6 * h_std
        s_m2 = _scale(g_std)
        blk["m_gelu"] = multiplier(_gelu_out_scale(ge, s_g), s_m2)
        w, b, s_fc2, mlp_std = site.linear(hidden, C, s_m2, g_std)
        s_mlp = _scale(mlp_std, bw["mlp_out"])
        blk.update(fc2_w=w, fc2_b=b, m_fc2=multiplier(s_fc2, s_mlp))
        x_std = float(np.hypot(mlp_std, res1_std))
        s_out = _scale(x_std, bw["att_block_out"])
        blk["m_res2_x"] = multiplier(s_mlp, s_out)
        blk["m_res2_id"] = multiplier(s_res1, s_out)
        fast_exp = fast_exp and _exp_fast_gate(sm, ge, s_attn, s_g)
        fast_poly = fast_poly and _poly_fast_gate(sm, ge, s_attn, s_g)
        blocks.append(blk)
        s_in, x_bits = s_out, bw["att_block_out"]
    p["blocks"] = blocks

    lb, ls, lsh = ln_site(x_bits)
    s_cls = _scale(1.0)
    p.update(lnf_bias_int=lb, lnf_shift=lsh, s_lnf=ls, m_lnf=multiplier(ls, s_cls))
    w, b, s_head, _ = site.linear(C, cfg["num_classes"], s_cls, 1.0)
    p.update(head_w=w, head_b=b, head_scale=s_head)
    out = {**cfg, "bits": bw, "fast_exp": fast_exp, "fast_poly": fast_poly,
           "use_lut": False, "sm_sum_i32": sum_i32, "ppoly_fastdiv": True}
    if cfg.get("tables"):
        out, p = with_tables(out, p, lambda entry: n_tok)
    return out, _tree(p)


# --- Swin ------------------------------------------------------------------------

def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention_mask(res, ws, shift):
    """0 / -100 additive mask [nW, n, n] of the shifted windows."""
    img = np.zeros((1, res, res, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, res // ws, ws, res // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    m = mw[:, None, :] - mw[:, :, None]
    return np.where(m != 0, -100.0, 0.0).astype(np.float32)


def swin_spec(cfg, seed):
    """(cfg with the freeze's flags, ``bits`` and ``layout``, numpy spec tree)."""
    sm, ge, ln = _families(cfg)
    site = _Sites(seed)

    def ln_site(dim, nbits):
        return site.layernorm(dim, ibert_ln_shift(dim, nbits) if ln == "ibert" else 0.0)

    p = {}
    s_input = _scale(1.0)
    p["s_input"] = s_input
    D = cfg["embed_dim"]
    w, b, s_conv, patch_std = site.linear(cfg["patch_size"] ** 2 * 3, D, s_input, 1.0)
    s_bn = _scale(patch_std)
    pn_b, pn_s, pn_sh = ln_site(D, 8)
    s_patch = _scale(1.0)
    s0 = _scale(1.0, 16)
    p["patch"] = {"w": w, "b": b, "m": multiplier(s_conv, s_bn),
                  "pn_bias_int": pn_b, "pn_shift": pn_sh, "s_pn": pn_s,
                  "m_norm": multiplier(pn_s, s_patch), "m_x0": multiplier(s_patch, s0)}

    fast_exp = fast_poly = sum_i32 = True
    blocks, layout = [], []
    s_in, x_std, x_bits = s0, 1.0, 16
    grid = cfg["img_size"] // cfg["patch_size"]
    i_blk = 0
    depths = cfg["depths"]
    for stage, depth in enumerate(depths):
        dim = D * 2 ** stage
        heads = cfg["stage_heads"][stage]
        res = grid // 2 ** stage
        ws = min(cfg["window_size"], res)
        n = ws * ws
        hidden = int(dim * cfg["mlp_ratio"])
        for d in range(depth):
            s_attn = np.float32(S_ATTN[sm][i_blk % 2])
            s_g = np.float32(S_GELU[ge][i_blk % 2])
            i_blk += 1
            blk = {}
            lb, ls, lsh = ln_site(dim, x_bits)
            s_a1 = _scale(1.0)
            blk.update(ln1_bias_int=lb, ln1_shift=lsh, s_ln1=ls,
                       m_ln1=multiplier(ls, s_a1))
            s_attn1 = np.float32(SWIN_S_ATTN1_RATIO * s_attn)
            q_std = float(np.sqrt(SCORE_SPREAD * s_attn1))
            w, b, s_qkv, q_std = site.linear(dim, 3 * dim, s_a1, 1.0,
                                             w_std=q_std / np.sqrt(dim))
            s_q = _scale(q_std)
            blk.update(qkv_w=w, qkv_b=b, m_qkv=multiplier(s_qkv, s_q))
            s_scores = np.float32(np.float32(s_q * s_q) * np.float32((dim // heads) ** -0.5))
            blk["m_attn"] = multiplier(s_scores, s_attn1)
            table = site.rng.normal(0.0, SWIN_REL_GAIN * SCORE_SPREAD * s_attn1,
                                    ((2 * ws - 1) ** 2, heads)).astype(np.float32)
            s_table = _sym_scale(8, table.min(), table.max())
            t_int = _quant(table, 8, s_table)
            bias = t_int[relative_position_index(ws).reshape(-1)]
            bias = bias.reshape(n, n, heads).transpose(2, 0, 1)
            blk["rel_bias_addend"] = _const(bias, s_table, s_attn)
            blk["m_attn2"] = multiplier(s_attn1, s_attn)
            blk["s_attn"] = s_attn
            shift = 0 if d % 2 == 0 or res <= cfg["window_size"] else ws // 2
            layout.append(("block", stage, shift))
            if shift > 0:
                blk["mask_int"] = np.round(attention_mask(res, ws, shift) / np.float32(s_attn))
            if sm == "ibert":
                c_int = np.floor(np.float32(io.EXP_C) / np.float32(s_attn * s_attn))
                blk["s_exp_act"] = _sym_scale(16, np.float32(0.0),
                                              np.float32(c_int * 2.0**30))
                s_sm = np.float32(2.0 / 2**8)
            else:
                s_sm = np.float32(1.0 / 2**7)
                sum_i32 = sum_i32 and _sum_fits_int32(
                    _np(io.shift_exp(_DIFFS, _t(s_attn), 15)), n)
            ctx_std = SWIN_CTX_GAIN[sm] * q_std
            s_a3 = _scale(ctx_std)
            blk["m_av"] = multiplier(np.float32(s_sm * s_q), s_a3)
            w, b, s_pj, proj_std = site.linear(dim, dim, s_a3, ctx_std)
            s_a4 = _scale(proj_std, 16)
            blk.update(proj_w=w, proj_b=b, m_proj=multiplier(s_pj, s_a4))
            res1_std = float(np.hypot(proj_std, x_std))
            s_res1 = _scale(res1_std, 16)
            blk["m_res1_x"] = multiplier(s_a4, s_res1)
            blk["m_res1_id"] = multiplier(s_in, s_res1)

            lb, ls, lsh = ln_site(dim, 16)
            s_m1 = _scale(1.0)
            blk.update(ln2_bias_int=lb, ln2_shift=lsh, s_ln2=ls, m_ln2=multiplier(ls, s_m1))
            h_std = float(s_g) * 127.0 / SIGMA
            w, b, s_fc1, h_std = site.linear(dim, hidden, s_m1, 1.0,
                                             w_std=h_std / np.sqrt(dim))
            blk.update(fc1_w=w, fc1_b=b, m_fc1=multiplier(s_fc1, s_g), s_gelu=s_g)
            g_std = 0.6 * h_std
            s_m2 = _scale(g_std)
            blk["m_gelu"] = multiplier(_gelu_out_scale(ge, s_g), s_m2)
            w, b, s_fc2, mlp_std = site.linear(hidden, dim, s_m2, g_std)
            s_mlp = _scale(mlp_std)
            blk.update(fc2_w=w, fc2_b=b, m_fc2=multiplier(s_fc2, s_mlp))
            x_std = float(np.hypot(mlp_std, res1_std))
            s_out = _scale(x_std, 16)
            blk["m_res2_x"] = multiplier(s_mlp, s_out)
            blk["m_res2_id"] = multiplier(s_res1, s_out)
            fast_exp = fast_exp and _exp_fast_gate(sm, ge, s_attn, s_g)
            fast_poly = fast_poly and _poly_fast_gate(sm, ge, s_attn, s_g)
            blocks.append(blk)
            s_in, x_bits = s_out, 16
        if stage < len(depths) - 1:
            layout.append(("merge", stage, 0))
            nb, ns, nsh = ln_site(4 * dim, x_bits)
            s_n = _scale(1.0)
            w, _, red_scale, red_std = site.linear(4 * dim, 2 * dim, s_n, 1.0)
            s_r = _scale(red_std)
            blocks.append({"merge": {
                "norm_bias_int": nb, "norm_shift": nsh, "s_norm": ns,
                "m_norm": multiplier(ns, s_n), "red_w": w,
                "m_red": multiplier(red_scale, s_r)}})
            s_in, x_std, x_bits = s_r, red_std, 8
    p["blocks"] = blocks

    dim = D * 2 ** (len(depths) - 1)
    lb, ls, lsh = ln_site(dim, x_bits)
    s_cls = _scale(1.0)
    p.update(lnf_bias_int=lb, lnf_shift=lsh, s_lnf=ls, m_lnf=multiplier(ls, s_cls))
    pool_std = 0.3
    s_pool = _scale(pool_std)
    p["m_pool"] = multiplier(s_cls, s_pool)
    w, b, s_head, _ = site.linear(dim, cfg["num_classes"], s_pool, pool_std)
    p.update(head_w=w, head_b=b, head_scale=s_head)
    out = {**cfg, "bits": bits("8"), "layout": [tuple(e) for e in layout],
           "fast_exp": fast_exp, "fast_poly": fast_poly, "use_lut": False,
           "sm_sum_i32": sum_i32, "ppoly_fastdiv": True}
    if cfg.get("tables"):
        out, p = with_tables(out, p, lambda e: min(cfg["window_size"], grid >> e[1]) ** 2)
    return out, _tree(p)


ARCHS = {"vit": vit_spec, "swin": swin_spec}


def make(cfg, seed):
    """The configuration's spec from ``seed``: (cfg with the freeze's flags,
    numpy spec tree)."""
    return ARCHS[cfg["arch"]](cfg, seed)
