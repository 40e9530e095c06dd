"""Global configuration for nums_tpu_torch.

Counterpart of ``nums_tpu/core/settings.py``: the backend name, the
matmul precision, the kernel gates, the default dtypes and the operator
alias tables. Every value is read from the environment at import and may
be reassigned on the module afterwards; the code reads it at call time.
"""

import os

import numpy as np

# Backend: "serial" (one device). The mesh backend is a later port.
backend_name = os.environ.get("NUMS_TPU_TORCH_BACKEND", "serial")

# Precision of float32 contractions (nums_tpu's NUMS_TPU_MATMUL_PRECISION).
# "default": the gram and Newton kernels run with bf16-rounded operands
# and f32 accumulation — the TPU's DEFAULT matmul class, which the
# reference runs on its main path. "float32" / "highest": plain float32
# torch ops with TF32 off, and the kernels stay off (unless forced below).
matmul_precision = os.environ.get("NUMS_TPU_TORCH_MATMUL_PRECISION", "default")

# Kernel gates, auto|0|1 (nums_tpu's NUMS_TPU_PALLAS_GRAM and
# NUMS_TPU_PALLAS_NEWTON). auto follows matmul_precision; 1 forces the
# kernel route (the plain version on CPU tensors), 0 forces plain ops.
gram_kernel = os.environ.get("NUMS_TPU_TORCH_GRAM", "auto")
newton_kernel = os.environ.get("NUMS_TPU_TORCH_NEWTON", "auto")

# Fused GLM Newton (nums_tpu's NUMS_TPU_GLM_FUSE): "1" runs the fused
# solver (``fast_glm.newton_fit``) for the families that have one; "0"
# forces the eager per-op solver loop.
glm_fuse = os.environ.get("NUMS_TPU_TORCH_GLM_FUSE", "1")

BF16_PRECISIONS = ("default", "fastest", "bfloat16")


def bf16_class() -> bool:
    """True when float32 contractions may run in the bf16-MAC class."""
    return matmul_precision in BF16_PRECISIONS


def kernel_enabled(gate: str) -> bool:
    """Resolve an auto|0|1 kernel gate against the precision setting."""
    if gate in ("0", "false", ""):
        return False
    if gate in ("1", "true"):
        return True
    return bf16_class()


def configure_precision():
    """Plain float32 ops stay float32 on the card: TF32 off for matmul and
    cuDNN (torch leaves cuDNN convolutions in TF32 by default)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_float_for(device) -> np.dtype:
    """Default float by device, as nums_tpu's ``configure_x64`` picks it:
    float64 on the CPU (NumPy parity), float32 on an accelerator."""
    return np.dtype(np.float64 if device.type == "cpu" else np.float32)


# Operator alias map: NumPy ufunc names that the op vocabulary spells
# differently (nums_tpu/core/settings.py:209-224).
np_ufunc_map = {
    "truediv": "true_divide",
    "sub": "subtract",
    "pow": "power",
    "mult": "multiply",
    "mul": "multiply",
    "tensordot": "multiply",
    "lt": "less",
    "le": "less_equal",
    "gt": "greater",
    "ge": "greater_equal",
    "eq": "equal",
    "ne": "not_equal",
}

# Pairwise reduction aliases (nums_tpu/core/settings.py:228-234).
np_pairwise_reduction_map = {
    "min": "fmin",
    "amin": "fmin",
    "max": "fmax",
    "amax": "fmax",
    "nansum": "add",
}
