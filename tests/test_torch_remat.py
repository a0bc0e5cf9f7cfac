"""Per-block rematerialisation (``repro_torch.models.remat``), the
reference's ``jax.checkpoint`` of each block and of the attention's chunk
body, on the CPU.

* Every reduced family's gradient with ``remat="block"`` against
  ``remat="none"``: the losses equal, every gradient element within
  ``GRAD_TOL`` of the largest (the recompute is the same arithmetic, but
  autograd may sum a weight's per-layer contributions in another order).
* ``FlopCounterMode`` shows the recompute: the blocks' forward products
  once more.
* Prefill and decode are unchanged: the same numbers, and no
  ``autograd.Function`` runs when no gradient is taken.
* Nesting under ``torch.autograd.grad`` and ``backward``, non-tensor
  outputs, and the train step (``make_train_step``) with and without.

Each family's two gradients are taken once (``grads``), under
``FlopCounterMode``, and shared by the tests that read them.
"""
import dataclasses
import functools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import get_model, remat
from repro_torch.models.module import tree_leaves, value_and_grad

FAMILIES = ["qwen3-0.6b", "granite-moe-1b-a400m", "internvl2-2b",
            "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"]
B, T = 2, 32
GRAD_TOL = 1e-5


def model(name, mode):
    return get_model(dataclasses.replace(ARCHS[name].reduced(), remat=mode))


def inputs(api, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = api.init(g, "cpu")
    batch = {"tokens": torch.randint(0, 256, (B, T), generator=g),
             "labels": torch.randint(0, 256, (B, T), generator=g)}
    c = api.cfg
    if c.family == "encdec":
        batch["frame_embeds"] = torch.randn(B, T, c.d_model, generator=g)
    if c.family == "vlm":
        batch["prefix_embeds"] = torch.randn(B, c.n_patches, c.d_model,
                                             generator=g)
    return params, batch


def flops(fn, *args):
    """(fn(*args), its FLOPs by ``FlopCounterMode``)."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return out, fc.get_total_flops()


@functools.lru_cache(maxsize=None)
def grads(name, mode):
    """((loss, gradient), its FLOPs) of the reduced ``name`` under
    ``mode`` on ``inputs``' seed-0 batch."""
    api = model(name, mode)
    params, batch = inputs(api)
    with ops.differentiable():
        return flops(value_and_grad(api.loss_fn), params, batch)


@pytest.mark.parametrize("name", FAMILIES)
def test_block_gradients_match_none(name):
    (lb, gb), _ = grads(name, "block")
    (ln, gn), _ = grads(name, "none")
    assert float(lb) == float(ln)
    for a, b in zip(tree_leaves(gb), tree_leaves(gn)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= GRAD_TOL * scale


def test_flop_counter_shows_the_recompute():
    """qwen3's gradient with remat counts every block's forward products
    once more than without: the loss's forward less the LM head."""
    block = model("qwen3-0.6b", "block")
    params, batch = inputs(block)
    c = block.cfg
    _, forward = flops(block.loss_fn, params, batch)
    lm_head = 2 * B * T * c.d_model * c.padded_vocab()
    assert grads("qwen3-0.6b", "block")[1] - \
        grads("qwen3-0.6b", "none")[1] == forward - lm_head


@pytest.mark.parametrize("name", ["qwen3-0.6b", "rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_prefill_and_decode_unchanged(name, monkeypatch):
    calls = []
    apply = remat._Remat.apply
    monkeypatch.setattr(remat._Remat, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    outs = {}
    for mode in ("block", "none"):
        api = model(name, mode)
        params, batch = inputs(api, seed=1)
        batch.pop("labels")
        with torch.no_grad():
            logits, cache = api.prefill_fn(params, batch, cache_len=T + 4)
            step = {"tokens": batch["tokens"][:, -1:], "cur_index": T}
            dlogits, _ = api.decode_fn(params, cache, step)
        outs[mode] = (logits, dlogits)
        # the grad mode is on and the parameters take no gradient
        api.prefill_fn(params, batch, cache_len=T)
    assert calls == []
    for a, b in zip(outs["block"], outs["none"]):
        assert torch.equal(a, b)


def _chain(ws, x, use):
    def block(h, w):
        def inner(a, b):
            return torch.sin(a @ b), None, 0.5
        y, none, half = remat.checkpoint(inner, h, w) if use else \
            inner(h, w)
        assert none is None and half == 0.5
        return torch.tanh(y) * half + h
    h = x
    for w in ws:
        h = remat.checkpoint(block, h, w) if use else block(h, w)
    return (h * h).sum()


def test_nested_checkpoint_under_autograd():
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(16, 16, generator=g) * 0.3 for _ in range(3)]
    x = torch.randn(8, 16, generator=g)
    wrt = {str(i): w for i, w in enumerate(ws)}
    _, plain = value_and_grad(
        lambda p: _chain([p[k] for k in wrt], x, False))(wrt)
    _, nested = value_and_grad(
        lambda p: _chain([p[k] for k in wrt], x, True))(wrt)
    plain = list(plain.values())
    for a, b in zip(nested.values(), plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    leaves = [w.clone().requires_grad_() for w in ws]
    _chain(leaves, x, True).backward()
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b, rtol=1e-6, atol=1e-6)


def test_train_step_with_and_without_remat():
    from repro_torch.configs import TrainConfig
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step
    out = {}
    for mode in ("block", "none"):
        api = model("qwen3-0.6b", mode)
        params, batch = inputs(api)
        step = make_train_step(api, TrainConfig(microbatches=2))
        out[mode] = step(params, adamw_init(params), batch)
    pb, _, mb = out["block"]
    pn, _, mn = out["none"]
    assert float(mb["loss"]) == float(mn["loss"])
    assert float(mb["grad_norm"]) == pytest.approx(float(mn["grad_norm"]),
                                                   rel=1e-6)
    for a, b in zip(tree_leaves(pb), tree_leaves(pn)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
