"""Write the reference package's serving results on two small fixtures,
for the PyTorch port to be held to on the card.

Two fixture configurations, cut from the full configs to a few layers and
narrow widths but at the full configs' head sizes (64) and chunk (256):

* rwkv6: 2 layers, d_model 128, 2 heads of 64, d_ff 256;
* zamba2: 3 layers (one group of 2 and a tail of 1, so two applications
  of the shared attention), d_model 128, Mamba2 heads of 64 with a state
  of 64, 2 attention heads of 64;

both float32, vocabulary 256, ``ssm_chunk=256``.  Their weights are seeded
numpy arrays from ``repro_torch.models.module.init_params_numpy`` (the
port's specs, which the CPU tests hold equal to the reference's), so both
packages load the same weights.  Two prompts of 128 tokens each run
through the reference's ``prefill`` and a greedy ``decode_step`` loop on
the CPU; the file keeps each prompt, its last-position prefill logits and
its greedy tokens, and the config overrides and seed that rebuild the
weights.  No weights are written.

Writes ``src/repro_torch/configs/serve_expected.json``.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/serve_expected.py
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "serve_expected.json"

FIXTURES = [
    dict(arch="rwkv6-7b", seed=1,
         overrides=dict(n_layers=2, d_model=128, n_heads=2, head_dim=64,
                        ssm_head_dim=64, d_ff=256, vocab_size=256,
                        dtype="float32", ssm_chunk=256)),
    dict(arch="zamba2-7b", seed=2,
         overrides=dict(n_layers=3, attn_every=2, d_model=128, n_heads=2,
                        n_kv_heads=2, head_dim=64, ssm_head_dim=64,
                        ssm_state=64, d_ff=256, vocab_size=256,
                        dtype="float32", ssm_chunk=256)),
]
PROMPT_LEN = 128
N_PROMPTS = 2
N_NEW = 8


def run_fixture(fx: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import get_model
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import get_model as port_model
    from repro_torch.models.module import init_params_numpy

    cfg = dataclasses.replace(ARCHS[fx["arch"]], **fx["overrides"])
    pcfg = dataclasses.replace(PORT_ARCHS[fx["arch"]], **fx["overrides"])
    weights = init_params_numpy(port_model(pcfg).specs(), fx["seed"])
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    api = get_model(cfg)
    rng = np.random.default_rng(fx["seed"])
    prompts = rng.integers(1, cfg.vocab_size, size=(N_PROMPTS, PROMPT_LEN))
    runs = []
    for prompt in prompts.tolist():
        logits, state = api.prefill_fn(
            params, {"tokens": jnp.asarray([prompt], jnp.int32)},
            cache_len=PROMPT_LEN + N_NEW)
        first = np.asarray(logits[0], np.float32)
        tokens = [int(np.argmax(first))]
        for step in range(N_NEW - 1):
            logits, state = api.decode_fn(
                params, state, {"tokens": jnp.asarray([[tokens[-1]]],
                                                      jnp.int32),
                                "cur_index": jnp.int32(PROMPT_LEN + step)})
            tokens.append(int(jnp.argmax(logits[0])))
        runs.append(dict(prompt=prompt, logits=first.tolist(),
                         tokens=tokens))
    return dict(fx, prompt_len=PROMPT_LEN, n_new=N_NEW, runs=runs)


def main() -> None:
    out = dict(note="reference package (JAX, CPU) prefill logits and "
                    "greedy tokens; written by tools/serve_expected.py",
               fixtures=[run_fixture(fx) for fx in FIXTURES])
    OUT.write_text(json.dumps(out) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
