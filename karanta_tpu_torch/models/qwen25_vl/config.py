"""Qwen2.5-VL architecture configuration.

Numerics-compatible with HF checkpoints (Qwen/Qwen2.5-VL-3B/7B-Instruct — the
reference's fine-tune base, configs/training/ocr/karanta_set_qwen_2_5_3B_vl.yaml:2,
and allenai/olmOCR-2-7B which is a Qwen2.5-VL-7B fine-tune, the reference
pipeline's default engine model — karanta/pipeline.py:1128-1131).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 1280
    depth: int = 32
    num_heads: int = 16
    intermediate_size: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112  # pixels; 8 pre-merge patches
    # None = full attention in every block (Qwen2-VL style)
    fullatt_block_indexes: "Tuple[int, ...] | None" = (7, 15, 23, 31)
    out_hidden_size: int = 2048
    in_channels: int = 3
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e4
    # architecture family knobs: Qwen2.5-VL = rmsnorm + gated silu MLP;
    # Qwen2-VL = layernorm + plain quick-gelu MLP
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    mlp_type: str = "gated"             # gated | plain
    hidden_act: str = "silu"            # silu | quick_gelu | gelu

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def window_patches(self) -> int:
        """Window side length in pre-merge patches (112/14 = 8)."""
        return self.window_size // self.patch_size

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_layers: int = 36
    num_heads: int = 16
    num_kv_heads: int = 2
    head_dim: int = 128
    intermediate_size: int = 11008
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 128000


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643
    name: str = "qwen2.5-vl"


def qwen25_vl_3b() -> VLMConfig:
    return VLMConfig(name="qwen2.5-vl-3b")


def qwen25_vl_7b() -> VLMConfig:
    return VLMConfig(
        name="qwen2.5-vl-7b",
        vision=VisionConfig(out_hidden_size=3584),
        text=TextConfig(
            vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
            num_kv_heads=4, head_dim=128, intermediate_size=18944,
            tie_word_embeddings=False,
        ),
    )


def qwen2_vl_7b() -> VLMConfig:
    """Qwen2-VL-7B architecture (base of allenai/olmOCR-7B-0725 — the
    reference's Model enum, karanta/constants.py:17-24)."""
    return VLMConfig(
        name="qwen2-vl-7b",
        vision=VisionConfig(
            intermediate_size=5120, out_hidden_size=3584,
            fullatt_block_indexes=None, norm_type="layernorm",
            mlp_type="plain", hidden_act="quick_gelu",
        ),
        text=TextConfig(
            vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
            num_kv_heads=4, head_dim=128, intermediate_size=18944,
            tie_word_embeddings=False,
        ),
    )


def qwen2_vl_2b() -> VLMConfig:
    return VLMConfig(
        name="qwen2-vl-2b",
        vision=VisionConfig(
            intermediate_size=5120, out_hidden_size=1536,
            fullatt_block_indexes=None, norm_type="layernorm",
            mlp_type="plain", hidden_act="quick_gelu",
        ),
        text=TextConfig(
            vocab_size=151936, hidden_size=1536, num_layers=28, num_heads=12,
            num_kv_heads=2, head_dim=128, intermediate_size=8960,
            tie_word_embeddings=True,
        ),
    )


def tiny_config(vocab_size: int = 1024) -> VLMConfig:
    """Small random-init config for tests: same topology, tiny dims."""
    return VLMConfig(
        name="qwen2.5-vl-tiny",
        vision=VisionConfig(
            hidden_size=64, depth=4, num_heads=4, intermediate_size=96,
            fullatt_block_indexes=(2,), out_hidden_size=64,
        ),
        text=TextConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=3, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            mrope_section=(2, 3, 3), tie_word_embeddings=True,
        ),
        image_token_id=9, video_token_id=10, vision_start_token_id=8,
        vision_end_token_id=11, eos_token_id=2, pad_token_id=0,
    )


def small_config(vocab_size: int = 1024) -> VLMConfig:
    """Mid-scale hermetic config (~40x tiny compute): enough capacity for
    a generalizing anchor-copy circuit, still single-chip-trainable in
    minutes. The round-4 closed loop showed tiny (hidden 64, 3 layers)
    plateauing at fresh-words CER 0.68 — a capacity ceiling, not a
    pipeline defect; this preset exists to prove the circuit trains
    (VERDICT r4 next #6)."""
    return VLMConfig(
        name="qwen2.5-vl-small",
        vision=VisionConfig(
            hidden_size=128, depth=6, num_heads=4, intermediate_size=256,
            fullatt_block_indexes=(2, 5), out_hidden_size=256,
        ),
        text=TextConfig(
            vocab_size=vocab_size, hidden_size=256, num_layers=6,
            num_heads=8, num_kv_heads=4, head_dim=32,
            intermediate_size=512, mrope_section=(4, 6, 6),
            tie_word_embeddings=True,
        ),
        image_token_id=9, video_token_id=10, vision_start_token_id=8,
        vision_end_token_id=11, eos_token_id=2, pad_token_id=0,
    )


PRESETS = {
    "qwen2.5-vl-3b": qwen25_vl_3b,
    "qwen2.5-vl-7b": qwen25_vl_7b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "olmocr-2": qwen25_vl_7b,   # olmOCR-2-7B is a Qwen2.5-VL-7B fine-tune
    "olmocr": qwen2_vl_7b,      # olmOCR-7B-0725 is a Qwen2-VL-7B fine-tune
    "small": small_config,
    "tiny": tiny_config,
}


def get_config(name: str) -> VLMConfig:
    key = name.lower()
    for alias, factory in PRESETS.items():
        if alias in key:
            return factory()
    raise ValueError(f"Unknown model preset {name!r}; known: {list(PRESETS)}")
