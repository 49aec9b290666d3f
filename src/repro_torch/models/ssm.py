"""Mamba-2 (SSD, arXiv:2405.21060) decode: the O(1) recurrent update of the
JAX package's ``models/ssm.py::ssm_decode_step``, in its dtype mix (bf16
activations and state, fp32 ``dt_bias`` / ``A_log`` / ``D`` and norm).

The chunked SSD scan (``ssd_chunked``, ``ssm_block``) is the training and
prefill path and is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
