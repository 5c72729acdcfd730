"""Name → model-constructor registry (same names as the JAX package's)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name: {name}")
        _REGISTRY[name] = fn
        return fn

    return deco


def build_model(name: str, **kwargs):
    # Import model modules lazily so the registry is populated on first use.
    import lyft3d_tpu_torch.models.unet  # noqa: F401
    import lyft3d_tpu_torch.models.deeplab  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(
            f"model {name!r} is unknown or not yet ported to lyft3d_tpu_torch; "
            f"ported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kwargs)


def list_models():
    import lyft3d_tpu_torch.models.unet  # noqa: F401
    import lyft3d_tpu_torch.models.deeplab  # noqa: F401

    return sorted(_REGISTRY)
