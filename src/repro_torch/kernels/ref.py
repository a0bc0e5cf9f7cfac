"""Plain PyTorch versions of the model zoo's kernels: the two recurrence
kernels, ports of the reference package's ``kernels/ref.py``, and blocked
flash attention, what the reference's ``kernels/flash_attention.py``
computes.  Shapes follow the kernels' conventions:

  wkv6:  r,k,w: (B,H,T,K), v: (B,H,T,V), u: (H,K), state: (B,H,K,V)
         recurrence  S_t = diag(w_t) S_{t-1} + k_t v_t^T
                     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
  ssd:   x: (B,H,T,P), dt: (B,H,T), B,C: (B,G,T,N), A: (H,) (negative),
         state: (B,H,P,N)
         recurrence  S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T
                     y_t = S_t C_t + D x_t
  flash attention:  q: (B,T,H,hd), k,v: (B,S,KV,hd); q head h reads KV
         head h*KV//H; online softmax over KV blocks

The chunked forms are what the reference's models run on the CPU, and
what the port runs on the CPU (``kernels/ops.py``).  They take decay
*differences* ``exp(cs_t - cs_s)`` inside a chunk, never ``exp(-cs)``
alone, so they stay finite at any chunk length.  The blocked forms are the
CUDA kernels' blocking: the chunked form over blocks of a fixed length
(WKV6 16 tokens, SSD 64), the last block shorter.  The sequential forms
are the recurrence itself, one token at a time, the oracle all the others
are held to.
"""
from __future__ import annotations

import torch


# ------------------------------------------------------------------- RWKV6

def wkv6_ref(r, k, v, w, u, state):
    """Sequential form.  Returns (y: (B,H,T,V), final state)."""
    T = r.shape[2]
    S = state
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]           # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=2), S


def _chunk_len(T: int, chunk: int) -> int:
    C = min(chunk, T)
    while T % C:
        C -= 1
    return C


def wkv6_chunked_ref(r, k, v, w, u, state, chunk: int = 64):
    """Chunked parallel form: dense work inside a chunk of C tokens, the
    state carried from chunk to chunk."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    C = _chunk_len(T, chunk)
    n = T // C
    rc, kc, vc, wc = (a.reshape(B, H, n, C, -1) for a in (r, k, v, w))
    logw = torch.log(torch.clamp_min(wc, 1e-38))          # (B,H,n,C,K)
    csum = torch.cumsum(logw, dim=3)                      # inclusive
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    S = state
    ys = []
    for i in range(n):
        rt, kt, vt, cs = rc[:, :, i], kc[:, :, i], vc[:, :, i], csum[:, :, i]
        cs_prev = torch.nn.functional.pad(cs, (0, 0, 1, 0))[:, :, :-1]
        # inter-chunk: y_t += (r_t * exp(cs_{t-1})) @ S
        y = torch.einsum("bhck,bhkv->bhcv", rt * torch.exp(cs_prev), S)
        # intra-chunk: M[t,s] = sum_k r_t[k] exp(cs_{t-1}-cs_s)[k] k_s[k], s<t;
        # the pairs s >= t are masked inside the exp (their exponents are
        # positive, and an overflow there would make the gradient NaN)
        ratio = torch.exp(torch.where(
            tri[None, None, :, :, None],
            cs_prev[:, :, :, None, :] - cs[:, :, None, :, :], -torch.inf))
        M = torch.einsum("bhck,bhcsk,bhsk->bhcs", rt, ratio, kt)
        M = torch.where(tri[None, None], M, 0.0)
        # diagonal (bonus) term: (r_t * u) . k_t
        diag = torch.einsum("bhck,hk,bhck->bhc", rt, u, kt)
        y = y + torch.einsum("bhcs,bhsv->bhcv", M, vt) + diag[..., None] * vt
        # S' = diag(exp(cs_C)) S + sum_s diag(exp(cs_C - cs_s)) k_s v_s^T
        decay_all = torch.exp(cs[:, :, -1:, :])           # (B,H,1,K)
        kdec = kt * torch.exp(cs[:, :, -1:, :] - cs)      # (B,H,C,K)
        S = decay_all[:, :, 0, :, None] * S + \
            torch.einsum("bhck,bhcv->bhkv", kdec, vt)
        ys.append(y)
    return torch.stack(ys, dim=2).reshape(B, H, T, V), S


def _blocked(chunked, args, timed, block: int):
    """``chunked`` over the first T // block * block tokens in chunks of
    ``block``, then over the shorter tail as one chunk, the state (the last
    of ``args``) carried between.  ``timed``: the positions of the args
    whose dim 2 is time."""
    *rest, state = args
    T = rest[timed[0]].shape[2]
    cut = T - T % block
    ys = []
    for lo, hi in ((0, cut), (cut, T)):
        if hi > lo:
            part = [a[:, :, lo:hi] if i in timed else a
                    for i, a in enumerate(rest)]
            y, state = chunked(*part, state, chunk=min(block, hi - lo))
            ys.append(y)
    return torch.cat(ys, dim=2), state


def wkv6_blocked_ref(r, k, v, w, u, state, block: int = 16):
    """The blocking of the CUDA kernel (K2): ``wkv6_chunked_ref`` over blocks
    of ``block`` tokens, the last one shorter."""
    return _blocked(wkv6_chunked_ref, (r, k, v, w, u, state), (0, 1, 2, 3),
                    block)


# ------------------------------------------------------------------- Mamba2

def ssd_ref(x, dt, A, Bm, Cm, D, state):
    """Sequential form.  x:(B,H,T,P) dt:(B,H,T) A:(H,) Bm/Cm:(B,G,T,N)
    D:(H,) state:(B,H,P,N).  Head h reads group h // (H // G)."""
    H, T = x.shape[1], x.shape[2]
    rep = H // Bm.shape[1]
    S = state
    ys = []
    for t in range(T):
        xt, dtt = x[:, :, t], dt[:, :, t]                  # (B,H,P), (B,H)
        bth = torch.repeat_interleave(Bm[:, :, t], rep, dim=1)
        cth = torch.repeat_interleave(Cm[:, :, t], rep, dim=1)
        decay = torch.exp(A[None, :] * dtt)                # (B,H)
        S = decay[..., None, None] * S + \
            (dtt[..., None] * xt)[..., :, None] * bth[..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, cth) +
                  D[None, :, None] * xt)
    return torch.stack(ys, dim=2), S


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, state, chunk: int = 64):
    """Chunked (state-space dual) form."""
    B_, H, T, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    C = _chunk_len(T, chunk)
    n = T // C
    xc = x.reshape(B_, H, n, C, P)
    dtc = dt.reshape(B_, H, n, C)
    Bc = torch.repeat_interleave(Bm, rep, dim=1).reshape(B_, H, n, C, N)
    Cc = torch.repeat_interleave(Cm, rep, dim=1).reshape(B_, H, n, C, N)
    a = A[None, :, None, None] * dtc                      # (B,H,n,C) negative
    csum = torch.cumsum(a, dim=3)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    S = state
    ys = []
    for i in range(n):
        xt, dtt, bt, ct, cs = (xc[:, :, i], dtc[:, :, i], Bc[:, :, i],
                               Cc[:, :, i], csum[:, :, i])
        # inter-chunk
        y = torch.einsum("bhcn,bhpn->bhcp", ct * torch.exp(cs)[..., None], S)
        # intra-chunk: L[t,s] = exp(cs_t - cs_s) for s <= t, the pairs s > t
        # masked inside the exp (as in ``wkv6_chunked_ref``)
        L = torch.exp(torch.where(tri[None, None],
                                  cs[:, :, :, None] - cs[:, :, None, :],
                                  -torch.inf))
        M = torch.einsum("bhcn,bhsn->bhcs", ct, bt) * L
        y = y + torch.einsum("bhcs,bhs,bhsp->bhcp", M, dtt, xt)
        # state update
        dec_all = torch.exp(cs[:, :, -1])                 # (B,H)
        kdec = torch.exp(cs[:, :, -1:] - cs)              # (B,H,C)
        S = dec_all[..., None, None] * S + torch.einsum(
            "bhc,bhc,bhcp,bhcn->bhpn", kdec, dtt, xt, bt)
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(B_, H, T, P)
    return y + D[None, :, None, None] * x, S


def ssd_blocked_ref(x, dt, A, Bm, Cm, D, state, block: int = 64):
    """The blocking of the CUDA kernel (K3): ``ssd_chunked_ref`` over blocks
    of ``block`` tokens, the last one shorter."""
    return _blocked(ssd_chunked_ref, (x, dt, A, Bm, Cm, D, state),
                    (0, 1, 3, 4), block)


# --------------------------------------------------------- flash attention

_NEG_INF = -1e30


def check_attention_domain(T: int, S: int, window: int) -> None:
    """Raise unless every query row has at least one key it may attend to
    (S >= 1, and with a window T < S + window).  A row with none has no
    defined softmax: the TPU kernel averages every value for it and a
    kernel that skips masked blocks would average fewer."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if S < 1 and T > 0:
        raise ValueError("attention over an empty key sequence")
    if window and T >= S + window:
        raise ValueError(f"window {window}: query rows at or past S - 1 + "
                         f"window = {S - 1 + window} would see no key "
                         f"(T={T}, S={S})")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = 128, block_kv: int = 128,
                          round_p: bool = False):
    """What the TPU kernel ``flash_attention_pallas`` computes, for any T
    and S: q, k, v in float32; an online softmax over KV blocks of
    ``block_kv`` keys with the (m, l, acc) state in float32; the mask
    ``qpos >= kpos`` (``causal``) and ``qpos - kpos < window``
    (``window`` > 0); masked scores -1e30; the output ``acc / max(l,
    1e-30)`` cast to q's dtype.  The probabilities stay in float32 for the
    product with v, unless ``round_p``: then they are rounded to v's dtype
    first, as ``layers.attention_ref`` and the bf16 CUDA kernel do (``l``
    is summed from the float32 probabilities either way).

    q: (B,T,H,hd); k, v: (B,S,KV,hd) -> (B,T,H,hd).  The CUDA kernel's
    yardstick on the card; never on the models' path."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    check_attention_domain(T, S, window)
    dev = q.device
    scale = hd ** -0.5
    heads = torch.arange(H, device=dev) * KV // H
    qf = q.float()
    kf, vf = k.float()[:, :, heads], v.float()[:, :, heads]   # (B,S,H,hd)
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, T, block_q):
        qb = qf[:, q0:q0 + block_q]
        qpos = q0 + torch.arange(qb.shape[1], device=dev)
        m = torch.full((B, H, qb.shape[1]), _NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qb.shape[1], hd), device=dev)
        for k0 in range(0, S, block_kv):
            kb, vb = kf[:, k0:k0 + block_kv], vf[:, k0:k0 + block_kv]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            kpos = k0 + torch.arange(kb.shape[1], device=dev)
            mask = torch.ones((qb.shape[1], kb.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = p.to(v.dtype).float() if round_p else p
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       pv, vb)
            m = m_new
        out[:, q0:q0 + block_q] = (acc / torch.clamp_min(l, 1e-30)[..., None]
                                   ).transpose(1, 2)
    return out.to(q.dtype)
