"""Global configuration for nums_tpu_torch.

Counterpart of ``nums_tpu/core/settings.py``: the backend name and the
mesh's shape, the hand-scheduled collective matmul and the ragged-shard
rule, the data directory and the checkpoint settings, the matmul precision, the
kernel gates, the default dtypes and the operator alias tables. Every
value is read from the environment at import and may be reassigned on the
module afterwards; the code reads it at call time.
"""

import os

import numpy as np


def _env_tuple(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return tuple(int(x) for x in raw.split(",") if x.strip())


# Backend: "serial" (one device) or "mesh" (one process per device under
# torch.distributed; arrays are DTensors over a DeviceMesh).
backend_name = os.environ.get("NUMS_TPU_TORCH_BACKEND", "serial")

# Mesh shape (nums_tpu's NUMS_TPU_CLUSTER_SHAPE). Empty = (world size, 1).
# Its product must equal the number of processes.
cluster_shape = _env_tuple("NUMS_TPU_TORCH_CLUSTER_SHAPE", ())

# Hand-scheduled collective matmul on the mesh (nums_tpu's
# NUMS_TPU_COLLECTIVE_MATMUL): "0" (default) runs a local product and lets
# DTensor (or, for x.T @ x, one all-reduce) join the parts; "ring",
# "summa" and "auto" as in ``core/ops/summa.py``.
collective_matmul = os.environ.get("NUMS_TPU_TORCH_COLLECTIVE_MATMUL", "0")

# Ragged axes on the mesh (nums_tpu's NUMS_TPU_PAD_SHARD): "1" shards an
# axis that the mesh does not divide (DTensor's uneven shards: the same
# rows the reference's padded layout gives each device); "0" replicates it.
pad_shard = os.environ.get("NUMS_TPU_TORCH_PAD_SHARD", "1") == "1"

# Directory that relative checkpoint, DiskArray and model names live under
# (nums_tpu's NUMS_TPU_DATA_DIR).
data_dir = os.environ.get(
    "NUMS_TPU_TORCH_DATA_DIR",
    os.path.join(os.path.expanduser("~"), ".nums_tpu_torch"),
)

# Checkpoint resilience (nums_tpu's NUMS_TPU_CHECKPOINT_REPLICAS,
# NUMS_TPU_CHECKPOINT_FSYNC and NUMS_TPU_REPLICA_DIRS): the number of full
# copies write_fs makes (1 = no replication); whether files and
# directories are fsynced around the publish renames (0 = rename ordering
# only); and the colon-separated roots that replica directories live
# under (empty: sibling ``<path>.replica<k>`` directories).
checkpoint_replicas = int(
    os.environ.get("NUMS_TPU_TORCH_CHECKPOINT_REPLICAS", "1"))
checkpoint_fsync = os.environ.get("NUMS_TPU_TORCH_CHECKPOINT_FSYNC",
                                  "1") == "1"
replica_roots = [
    p for p in os.environ.get("NUMS_TPU_TORCH_REPLICA_DIRS", "").split(":")
    if p
]

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

# TSQR algorithm (nums_tpu's NUMS_TPU_TSQR): "auto" takes CholeskyQR2 (all
# GEMMs and triangular solves) on a CUDA backend and the Householder panel
# tree on the CPU; "cholqr2" and "householder" force one. CholeskyQR2 is
# orthogonal to about eps for cond(X) up to about 1/sqrt(eps); the
# Householder tree holds at any conditioning, and takes every wide matrix.
tsqr_method = os.environ.get("NUMS_TPU_TORCH_TSQR", "auto")

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
