"""Config registry: ``get_config("<arch-id>")`` and the assigned shapes."""
from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.configs.shapes import SHAPES

_ARCH_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-125m": "xlstm_125m",
    "whisper-base": "whisper_base",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-3-8b": "granite_3_8b",
    "llama3-8b": "llama3_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "chatglm3-6b": "chatglm3_6b",
    "mobilenetv2-cifar": "mobilenetv2_cifar",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "mobilenetv2-cifar")


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    mod = _ARCH_MODULES.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def get_shape(shape_id: str) -> InputShape:
    return SHAPES[shape_id]


__all__ = [
    "ModelConfig", "InputShape", "TrainConfig", "SHAPES", "ARCH_IDS",
    "get_config", "get_shape",
]
