"""Model configurations of the model zoo: the dataclasses of the
reference package's ``configs/base.py`` that the port's models, serving
path and training framework read (``ModelConfig``, ``ShapeConfig``,
``SHAPES``, ``FULL_ATTENTION_ONLY``, ``shape_applicable``,
``TrainConfig``), copied so that the port imports nothing of the
reference.  The reference's ``HW`` table is not copied: it holds one TPU
generation's rates.  ``HW`` here is the NVIDIA H100 SXM's, which the
dry-run (``launch/dryrun.py``) divides by and ``chip_smoke.py``'s bounds
read.

``ModelConfig.use_pallas`` stays so that the field names match, but the
port does not consult it: ``kernels/ops.py`` dispatches on the device of
the tensors it is given (CUDA kernel on the card, plain version on the
host).  ``dtype`` is the compute dtype's name; parameters are float32
masters cast to it at each use.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_parallelism: str = "tp"       # tp | ep  (ep = experts over 'model')
    # attention variants
    sliding_window: int = 0           # 0 = full attention (mixtral: 4096)
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0               # zamba2: shared attn block cadence
    # enc-dec
    n_enc_layers: int = 0
    enc_len_cap: int = 4096
    # vlm
    n_patches: int = 0                # vlm: prefix patch embeddings
    frontend_stub: bool = False
    # numerics / implementation
    dtype: str = "bfloat16"
    use_pallas: bool = False          # kept so the field names match the
                                      # reference; the port does not read it
    attn_chunk_q: int = 2048
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 256
    remat: str = "block"              # none | block
    head_pad_to: int = 0              # pad n_heads for TP divisibility
    # beyond-paper perf knobs (EXPERIMENTS.md §Perf; default = baseline off)
    attn_causal_skip: bool = False    # skip fully-masked KV chunks
    moe_scatter_out: bool = False     # reduce-scatter MoE output over seq
    pin_weight_shards: bool = False   # re-constrain per-layer weight slices
                                      # (stops XLA replicating attn weights
                                      # per decode step)

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_heads(self) -> int:
        if self.head_pad_to:
            return _pad_to(self.n_heads, self.head_pad_to)
        return self.n_heads

    def padded_vocab(self, multiple: int = 16) -> int:
        return _pad_to(self.vocab_size, multiple)

    def reduced(self) -> "ModelConfig":
        """Smoke-test-size config of the same family (per spec item f)."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state or self.family in ("ssm", "hybrid") else self.ssm_head_dim,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            attn_chunk_q=16, attn_chunk_kv=16, ssm_chunk=8,
            enc_len_cap=32, head_pad_to=0,
            capacity_factor=4.0,       # no token drops in smoke tests
            dtype="float32",
        )
        return replace(self, **kw)

    def active_params_per_token_factor(self) -> float:
        """Fraction of FFN params active per token (MoE top-k / E)."""
        if self.n_experts:
            return self.top_k / self.n_experts
        return 1.0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs with a full (non-windowed, non-recurrent) attention path cannot run
# the sub-quadratic long-context shape
FULL_ATTENTION_ONLY = {
    "deepseek-67b", "deepseek-coder-33b", "qwen3-0.6b", "phi3-mini-3.8b",
    "internvl2-2b", "granite-moe-1b-a400m", "seamless-m4t-large-v2",
}


def shape_applicable(arch: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and arch in FULL_ATTENTION_ONLY:
        return False
    return True


@dataclass(frozen=True)
class TrainConfig:
    """The training run's settings, field for field the reference's.  As
    in the reference, ``make_train_step`` reads neither ``z_loss`` (the
    models' losses fix it at 1e-4) nor ``grad_compression`` (int8
    compression is ``train.compression``'s own step)."""
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    microbatches: int = 1            # grad accumulation
    grad_compression: str = "none"   # none | int8
    cast_params_bf16: bool = False   # mixed precision: bf16 compute copy,
                                     # f32 master in the optimizer
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


# NVIDIA H100 SXM5 80GB, per GPU, from NVIDIA's H100 Tensor Core GPU
# datasheet: 989 TFLOP/s dense bf16 (its 1,979 is with 2:4 sparsity), 67
# TFLOP/s float32, 3.35 TB/s and 80 GB of HBM3, and fourth-generation
# NVLink's 900 GB/s, which it counts in both directions: 450 GB/s each way.
HW = dict(
    peak_flops_bf16=989e12,     # FLOP/s, dense bf16 on the tensor cores
    peak_flops_f32=67e12,       # FLOP/s, float32 outside the tensor cores
    hbm_bw=3.35e12,             # bytes/s
    nvlink_bw_per_gpu=450e9,    # bytes/s, one direction
    hbm_bytes=80e9,
)
