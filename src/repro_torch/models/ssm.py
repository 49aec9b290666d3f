"""Mamba-2 (SSD, arXiv:2405.21060): the JAX package's ``models/ssm.py`` in
its dtype mix (bf16 activations and state, fp32 ``dt_bias`` / ``A_log`` /
``D`` and norm). Training and prefill run the chunked SSD algorithm
(``ssd_chunked``: the intra-chunk quadratic form plus the inter-chunk state
recurrence, a Python loop over chunks here where JAX scans); decode runs
the O(1) recurrent update (``ssm_decode_step``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A, B, C, D, *, chunk=128):
    """SSD scan. x [b,S,H,P]; dt [b,S,H]; A [H]; B,C [b,S,N]; D [H].

    Returns y [b,S,H,P] (float32 when ``D`` is, as JAX promotes). N = state
    dim, P = head dim. The [c,c] quadratic form is materialized per chunk
    only, bounding activation memory at b·c·c·H values regardless of S."""
    b, S, H, Pd = x.shape
    N = B.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of chunk {c}")
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    h = torch.zeros((b, H, N, Pd), dtype=x.dtype, device=x.device)
    ys = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        dA = dtc * A[None, None, :]
        dA_cum = torch.cumsum(dA, dim=1)                          # [b,c,H]
        dA_total = dA_cum[:, -1]                                  # [b,H]

        # intra-chunk quadratic form: L[i,j] = exp(Σ_{j<k<=i} dA).
        # mask BEFORE exp: the upper triangle has positive seg whose exp
        # overflows to inf and poisons the backward pass
        seg = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]       # [b,c,c,H]
        seg = torch.where(causal[None, :, :, None], seg, -1e30)
        L = torch.exp(seg)
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)                 # [b,c,c]
        gate = (L * CB[..., None]).to(xc.dtype)                   # [b,c,c,H]
        y_intra = torch.einsum("bijh,bjhp,bjh->bihp", gate, xc,
                               dtc.to(xc.dtype))

        # contribution of the carried state
        decay_from_start = torch.exp(dA_cum).to(xc.dtype)         # [b,c,H]
        y_inter = torch.einsum("bin,bhnp,bih->bihp", Cc, h,
                               decay_from_start)

        # update the carried state
        decay_to_end = torch.exp(dA_total[:, None, :] - dA_cum)   # [b,c,H]
        state = torch.einsum("bjn,bjh,bjhp->bhnp", Bc,
                             (decay_to_end * dtc).to(xc.dtype), xc)
        h = h * torch.exp(dA_total)[..., None, None].to(xc.dtype) + state

        ys.append(y_intra + y_inter + xc * D[None, None, :, None])
    return torch.cat(ys, dim=1)


def ssm_block(p, x, *, headdim, d_state, chunk=128, conv_width=4):
    """Full Mamba-2 mixer: in_proj → causal conv → SSD → gate → out_proj.

    p: {in_proj [D, 2*di + 2*N + H], conv [w, di + 2*N], dt_bias [H],
        A_log [H], D [H], norm [di], out_proj [di, D]}.
    """
    Bsz, S, Dm = x.shape
    H = p["A_log"].shape[0]
    di = H * headdim
    N = d_state

    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                  zxbcdt[..., 2 * di + 2 * N:])

    # depthwise causal conv over (x, B, C), summed tap by tap in order
    w = p["conv"]                                         # [w, di+2N]
    pad = F.pad(xbc, (0, 0, conv_width - 1, 0))
    conv = pad[:, 0:S] * w[0][None, None]
    for i in range(1, conv_width):
        conv = conv + pad[:, i:i + S] * w[i][None, None]
    xbc = F.silu(conv)

    xs, B, C = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    xs = xs.reshape(Bsz, S, H, headdim)
    dt = F.softplus(dt + p["dt_bias"][None, None])        # [b,S,H] fp32
    A = (-torch.exp(p["A_log"].float())).to(x.dtype)

    y = ssd_chunked(xs, dt.to(x.dtype), A, B, C, p["D"], chunk=chunk)
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba-2 uses norm(y * silu(z)))
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
         * (1.0 + p["norm"].float())).to(x.dtype)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def ssm_decode_step(p, x, state, conv_state, *, headdim, d_state,
                    conv_width=4):
    """O(1) recurrent decode. x [B,1,D]; state [B,H,N,P]; conv_state
    [B,w-1,di+2N]. Returns (y [B,1,D], state', conv_state')."""
    Bsz, _, Dm = x.shape
    H = p["A_log"].shape[0]
    di = H * headdim
    N = d_state

    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                  zxbcdt[..., 2 * di + 2 * N:])

    xbc_hist = torch.cat([conv_state, xbc], dim=1)        # [B,w,di+2N]
    conv = torch.einsum("bwe,we->be", xbc_hist, p["conv"])[:, None]
    new_conv_state = xbc_hist[:, 1:]
    xbc_t = F.silu(conv)

    xs, B, C = (xbc_t[..., :di], xbc_t[..., di:di + N],
                xbc_t[..., di + N:])
    xs = xs.reshape(Bsz, H, headdim)
    dt_t = F.softplus(dt[:, 0] + p["dt_bias"][None])      # [B,H] fp32
    A = (-torch.exp(p["A_log"].float())).to(x.dtype)

    decay = torch.exp(dt_t * A[None])                      # [B,H] fp32
    # h' = decay·h + dt·B⊗x ; y = C·h' + D·x
    outer = torch.einsum("bn,bhp->bhnp", B[:, 0], xs) * \
        dt_t[..., None, None].to(x.dtype)
    state = state * decay[..., None, None].to(x.dtype) + outer
    y = torch.einsum("bn,bhnp->bhp", C[:, 0], state) + \
        xs * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, di)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
         * (1.0 + p["norm"].float())).to(x.dtype)
    return (torch.einsum("bse,ed->bsd", y, p["out_proj"]), state,
            new_conv_state)
