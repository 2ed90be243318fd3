"""Model and GBA configs of the LM training path.

A copy of ``repro.configs.base``, field for field, so that a config names
the same model in both packages.  ``ModelConfig`` carries every field of
the reference, and the port runs each of them;
``repro_torch.models.transformer.check_supported`` refuses a layer kind
that does not exist.  ``INPUT_SHAPES`` are the reference's four, which
``launch.steps.build_step`` and the dry run (``launch.dryrun``) read.
``TrainConfig`` is not copied: nothing in the port reads it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Sequence

LayerKind = Literal["global", "local", "mamba", "mamba_attn", "cross", "moe",
                    "local_moe"]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  The layer stack is
    ``block_pattern * num_repeats`` after ``prefix_layers``; the repeated
    part keeps its parameters stacked on a leading ``num_repeats`` axis."""

    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "recsys"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads
    block_pattern: Sequence[LayerKind] = ("global",)
    prefix_layers: Sequence[LayerKind] = ()
    sliding_window: int = 0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_weight: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_head_dim: int = 64
    # VLM / audio frontends
    num_image_tokens: int = 0
    encoder_layers: int = 0
    encoder_frames: int = 0
    # the reference's speed variants
    attn_q_chunk: int = 0
    remat_blocks: bool = False
    loss_seq_chunk: int = 0
    mamba_split_proj: bool = False
    # misc
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_long_context(self) -> bool:
        """Whether a 500k-token decode is in regime, as the reference
        decides it: a Mamba2 mixer, or a native sliding-window layer."""
        kinds = set(self.block_pattern) | set(self.prefix_layers)
        if kinds & {"mamba", "mamba_attn"}:
            return True
        return "local" in kinds and self.sliding_window > 0

    @property
    def num_repeats(self) -> int:
        n_scanned = self.num_layers - len(self.prefix_layers)
        if n_scanned % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: {n_scanned} repeated layers not divisible by "
                f"a pattern of {len(self.block_pattern)}")
        return n_scanned // len(self.block_pattern)

    def reduced(self) -> "ModelConfig":
        """The reference's smoke variant of the same family (<= 2 pattern
        repeats, d_model <= 256, <= 4 experts), field for field."""
        pat = tuple(self.block_pattern)
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=len(self.prefix_layers) + len(pat),
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            num_image_tokens=16 if self.num_image_tokens else 0,
            encoder_layers=min(self.encoder_layers, 2)
            if self.encoder_layers else 0,
            encoder_frames=min(self.encoder_frames, 32)
            if self.encoder_frames else 0,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class GBAConfig:
    """Hyper-parameters of the paper's technique (Sec. 4.1)."""

    local_batch: int = 1_024            # B_a
    buffer_size: int = 8                # M (gradients aggregated per step)
    staleness_tolerance: int = 4        # iota in Eq. (1)
    num_workers: int = 0                # N_a; 0 -> M (paper sets N_a = M)
