"""Write the reference package's serving results on six small fixtures,
for the PyTorch port to be held to on the card.

Six fixture configurations, cut from the full configs to a few layers and
narrow widths but at the full configs' head sizes and chunks:

* rwkv6: 2 layers, d_model 128, 2 heads of 64, d_ff 256, ``ssm_chunk``
  256;
* zamba2: 3 layers (one group of 2 and a tail of 1, so two applications
  of the shared attention), d_model 128, Mamba2 heads of 64 with a state
  of 64, 2 attention heads of 64, ``ssm_chunk`` 256;
* qwen3: 2 layers, d_model 256, 4 query heads of 128 over 2 KV heads,
  ``qk_norm``, d_ff 512;
* granite-moe: 2 layers, d_model 128, 2 query heads of 64 over 1 KV head,
  32 experts of d_ff 64, top-8, capacity factor 1.25 (the full config's),
  so that both prefill and decode drop tokens;
* internvl2: 2 layers, d_model 128, 2 query heads of 128 over 1 KV head,
  d_ff 256, the full config's 256 patch positions, prompts of 384 tokens
  (256 placeholders, which zero patch embeddings replace, and 128 text
  tokens);
* seamless-m4t: 2 encoder and 2 decoder layers, d_model 128, 2 heads of 64
  (the full config's head size, as many KV heads), d_ff 256, each prompt
  over zero frame embeddings as long as the prompt (the engine's frames);

all float32, vocabulary 256.  Their weights are seeded numpy arrays from
``repro_torch.models.module.init_params_numpy`` (the port's specs, which
the CPU tests hold equal to the reference's), so both packages load the
same weights.  Two prompts each run through the reference on the CPU:
rwkv6 and zamba2 through its ``prefill`` and a greedy ``decode_step``
loop, one prompt at a time (the reference's engine cannot hold zamba2's
state); the transformer and encoder-decoder fixtures through its
``ServeEngine`` with 2 slots, as the port's engine serves them (an MoE
decode step's capacity spans both slots).  The file keeps each prompt, its last-position prefill
logits and its greedy tokens, and the config overrides and seed that
rebuild the weights.  No weights are written.

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
    dict(arch="qwen3-0.6b", seed=3, slots=2,
         overrides=dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=128, d_ff=512, vocab_size=256,
                        dtype="float32")),
    dict(arch="granite-moe-1b-a400m", seed=4, slots=2,
         overrides=dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                        head_dim=64, d_ff=64, vocab_size=256,
                        n_experts=32, top_k=8, capacity_factor=1.25,
                        dtype="float32")),
    dict(arch="internvl2-2b", seed=5, slots=2, prompt_len=384,
         overrides=dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                        head_dim=128, d_ff=256, vocab_size=256,
                        n_patches=256, dtype="float32")),
    dict(arch="seamless-m4t-large-v2", seed=6, slots=2,
         overrides=dict(n_layers=2, n_enc_layers=2, d_model=128, n_heads=2,
                        n_kv_heads=2, head_dim=64, d_ff=256, vocab_size=256,
                        dtype="float32")),
]
PROMPT_LEN = 128
N_PROMPTS = 2
N_NEW = 8


def run_fixture(fx: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import get_model
    from repro.serve import Request, ServeEngine
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import get_model as port_model
    from repro_torch.models.module import init_params_numpy

    cfg = dataclasses.replace(ARCHS[fx["arch"]], **fx["overrides"])
    pcfg = dataclasses.replace(PORT_ARCHS[fx["arch"]], **fx["overrides"])
    weights = init_params_numpy(port_model(pcfg).specs(), fx["seed"])
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    api = get_model(cfg)
    prompt_len = fx.get("prompt_len", PROMPT_LEN)
    rng = np.random.default_rng(fx["seed"])
    prompts = rng.integers(1, cfg.vocab_size, size=(N_PROMPTS, prompt_len))

    def prefill(prompt):
        batch = {"tokens": jnp.asarray([prompt], jnp.int32)}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = jnp.zeros((1, cfg.n_patches,
                                                cfg.d_model), jnp.float32)
        if cfg.family == "encdec":      # the reference engine's frames
            batch["frame_embeds"] = jnp.zeros(
                (1, min(len(prompt), cfg.enc_len_cap), cfg.d_model),
                jnp.float32)
        return api.prefill_fn(params, batch, cache_len=prompt_len + N_NEW)

    if "slots" in fx:                   # the reference's engine
        eng = ServeEngine(api, params, batch_slots=fx["slots"],
                          max_seq=prompt_len + N_NEW)
        reqs = [Request(prompt=p, max_tokens=N_NEW, rid=i)
                for i, p in enumerate(prompts.tolist())]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        runs = [dict(prompt=r.prompt,
                     logits=np.asarray(prefill(r.prompt)[0][0],
                                       np.float32).tolist(),
                     tokens=list(r.output)) for r in reqs]
        return dict(fx, prompt_len=prompt_len, n_new=N_NEW, runs=runs)
    runs = []
    for prompt in prompts.tolist():
        logits, state = prefill(prompt)
        first = np.asarray(logits[0], np.float32)
        tokens = [int(np.argmax(first))]
        for step in range(N_NEW - 1):
            logits, state = api.decode_fn(
                params, state, {"tokens": jnp.asarray([[tokens[-1]]],
                                                      jnp.int32),
                                "cur_index": jnp.int32(prompt_len + step)})
            tokens.append(int(jnp.argmax(logits[0])))
        runs.append(dict(prompt=prompt, logits=first.tolist(),
                         tokens=tokens))
    return dict(fx, prompt_len=prompt_len, n_new=N_NEW, runs=runs)


def main() -> None:
    out = dict(note="reference package (JAX, CPU) prefill logits and "
                    "greedy tokens; written by tools/serve_expected.py",
               fixtures=[run_fixture(fx) for fx in FIXTURES])
    OUT.write_text(json.dumps(out) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
