"""Process setup before a CLI builds anything (port of
``da_detect_tpu/utils/env.py``; reference utils/env.py:7-37).

The reference's hook stays: ``$TORCH_DETECTRON_ENV_MODULE`` names a Python
file (or module) whose ``setup_environment()`` runs first. The JAX package's
own setup is its persistent XLA compilation cache, which has no counterpart
here: the port compiles nothing per model; its CUDA kernels are built once,
at first use, into ``kernels/build/``.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

import torch

ENV_MODULE = "TORCH_DETECTRON_ENV_MODULE"


def setup_environment() -> None:
    path = os.environ.get(ENV_MODULE)
    if not path:
        return
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "da_detect_custom_environment", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(path)
    if not callable(getattr(module, "setup_environment", None)):
        raise ImportError(f"{ENV_MODULE}={path}: the module has no "
                          "setup_environment()")
    module.setup_environment()


def reference_numerics() -> None:
    """Make float32 convolutions and matmuls on the card full float32
    (cuDNN defaults to TF32 for convolutions) and bfloat16 matmuls
    accumulate in float32, as the JAX package's do: the arithmetic of the
    eager model (``entry.prepare_model``) and of a serving artifact loaded
    for the card (``engine/serving.py::load_serving``). The settings are
    the process's."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
