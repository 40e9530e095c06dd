"""Facts of the device a run uses, read by the benchmark itself."""

import subprocess


def missing_cards(torch, chips):
    """Why a run on ``chips`` CUDA cards cannot start here, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"{chips} cards asked for, {torch.cuda.device_count()} "
                f"visible")
    return None


def power_limits():
    """Each card's name and power limit as ``nvidia-smi`` reads them, or
    [] where it cannot."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in proc.stdout.splitlines()
            if line.strip()]


def describe(torch, device, world, peak_bytes):
    """The result's ``device`` object."""
    if device.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(device)
    else:
        platform, kind = device.type, device.type
    out = {"platform": platform, "kind": kind, "count": world,
           "memory_peak_bytes": int(peak_bytes)}
    if device.type == "cuda":
        out["nvidia_smi"] = power_limits()[:world]
    return out
