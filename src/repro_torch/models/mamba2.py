"""Mamba2 block (state space dual), used by the Zamba2 hybrid.

A port of the reference package's ``models/mamba2.py``: a gated (z)
branch, a causal depthwise conv, the selective SSM with a scalar decay
exp(A*dt) per head and grouped B/C (G groups), a gated RMSNorm and the out
projection.  The SSD recurrence runs through ``kernels.ops.ssd`` (the CUDA
kernel on the card, the plain chunked form on the CPU).  The decode state
is O(1) in the sequence: the conv tail and one P x N matrix per head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import WHOLE, compute_dtype, rms_norm
from .module import ParamSpec

_CONV_K = 4
_EXPAND = 2
_GROUPS = 1


def dims(cfg: ModelConfig):
    d_in = _EXPAND * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state, _GROUPS


def mamba_specs(cfg: ModelConfig, L: int) -> dict:
    d = cfg.d_model
    d_in, H, P, N, G = dims(cfg)

    def lay(shape, logical, **kw):
        return ParamSpec((L,) + shape, ("layers",) + logical, **kw)

    return {
        "ln": lay((d,), ("embed",), init="ones"),
        "Wz": lay((d, d_in), ("embed", "mlp")),
        "Wx": lay((d, d_in), ("embed", "mlp")),
        "WB": lay((d, G * N), ("embed", None)),
        "WC": lay((d, G * N), ("embed", None)),
        "Wdt": lay((d, H), ("embed", "heads")),
        "dt_bias": lay((H,), ("heads",), init="zeros"),
        "conv": lay((_CONV_K, d_in), ("conv", "mlp"), scale=0.5),
        "A_log": lay((H,), ("heads",), init="zeros"),
        "D": lay((H,), ("heads",), init="zeros"),
        "norm": lay((d_in,), ("mlp",), init="ones"),
        "Wo": lay((d_in, d), ("mlp", "embed")),
    }


def _causal_conv(x, kernel, tail=None):
    """Depthwise causal conv; x: (B,T,C), kernel: (K,C), tail: (B,K-1,C).
    Returns (out, new tail)."""
    K = kernel.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * kernel[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + T] * kernel[i].to(x.dtype)
    return out, xp[:, -(K - 1):]


def block_apply(h, wb, cfg: ModelConfig, state, tp=WHOLE):
    """h: (B,T,d); state: {'conv': (B,K-1,d_in) or None for zeros, 'S':
    (B,H,P,N)}.  ``tp``: the tensor-parallel hooks (``layers.Whole``); the
    ``d_in`` columns and heads are those of ``wb`` (a rank's), the gated
    norm ``tp.norm`` over all of ``d_in``."""
    x0 = tp.full(rms_norm(h, wb["ln"]))
    B, T, d = x0.shape
    _, _, P, N, G = dims(cfg)
    H = wb["A_log"].shape[0]
    z = x0 @ wb["Wz"].to(x0.dtype)
    xin = x0 @ wb["Wx"].to(x0.dtype)
    xc, conv_tail = _causal_conv(xin, wb["conv"], state["conv"])
    xc = F.silu(xc)
    Bm = (x0 @ wb["WB"].to(x0.dtype)).reshape(B, T, G, N).transpose(1, 2)
    Cm = (x0 @ wb["WC"].to(x0.dtype)).reshape(B, T, G, N).transpose(1, 2)
    dt = F.softplus(x0.float() @ wb["Wdt"] + wb["dt_bias"])
    xh = xc.reshape(B, T, H, P).transpose(1, 2)           # (B,H,T,P)
    A = -torch.exp(wb["A_log"].float())
    y, S = kops.ssd(xh.float(), dt.transpose(1, 2), A, Bm.float(),
                    Cm.float(), wb["D"].float(), state["S"],
                    chunk=cfg.ssm_chunk)
    y = y.transpose(1, 2).reshape(B, T, H * P).to(h.dtype)
    y = tp.norm(y * F.silu(z), wb["norm"])
    out = tp.row(y, wb["Wo"])
    return h + out, {"conv": conv_tail, "S": S}


def zero_state(cfg: ModelConfig, B: int, dtype, device):
    d_in, H, P, N, G = dims(cfg)
    return {"conv": torch.zeros((B, _CONV_K - 1, d_in), dtype=dtype,
                                device=device),
            "S": torch.zeros((B, H, P, N), dtype=torch.float32,
                             device=device)}


def state_specs(cfg: ModelConfig, L: int, batch: int) -> dict:
    d_in, H, P, N, G = dims(cfg)
    dt = compute_dtype(cfg)
    return {
        "conv": ParamSpec((L, batch, _CONV_K - 1, d_in),
                          ("layers", "batch", "conv", "mlp"),
                          init="zeros", dtype=dt),
        "S": ParamSpec((L, batch, H, P, N),
                       ("layers", "batch", "heads", None, "state"),
                       init="zeros", dtype=torch.float32),
    }
