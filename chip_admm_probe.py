"""Why the l1 logistic ADMM fit stalls at 1000 columns: its residuals and
ρ step by step, on one card.

The fit is ``LogisticRegression(solver="admm", penalty="l1")`` on X drawn
as ``chip_smoke.py`` draws phase 18's (rows x 1000 fp32 on a world-1 mesh,
planted labels, C = 4000 / rows, admm_rho = rows / 4). The ADMM loop is
replaced for the run by a copy that records, each step, the primal
residual r, the dual residual s, ρ, the nonzeros of z and how many of z's
entries changed; the fit's optimality is ``chip_smoke._l1_kkt64``. Each
setting prints one JSON line (the last steps of its record).

    chiprun --timeout 600 -- python3 chip_admm_probe.py
"""

import json
import math
import os
import sys
import tempfile
import time

SETTINGS = ((2_500_000, 40), (2_500_000, 120), (250_000, 40),
            (62_500, 40), (250_000, 120))


def _recording_loop(log):
    """``fast_glm._admm_loop`` with each step's (r, s, ρ, nonzeros of z,
    entries of z changed) appended to ``log``."""
    import torch

    def loop(beta_update, z_update, beta0, tol, max_iter, rho):
        dt, dev = beta0.dtype, beta0.device
        rho = torch.as_tensor(rho, dtype=dt, device=dev)
        inf = torch.full((), math.inf, dtype=dt, device=dev)
        beta, z, u, r, s = beta0, beta0, torch.zeros_like(beta0), inf, inf
        it = 0
        while it < max_iter and bool(torch.maximum(r, s) > tol):
            beta = beta_update(beta, z - u, rho)
            z_new = z_update(beta + u, rho)
            u = u + beta - z_new
            r = torch.max(torch.abs(beta - z_new))
            s = torch.max(torch.abs(rho * (z_new - z)))
            rho_new = torch.where(r > 10.0 * s, rho * 2.0, torch.where(
                s > 10.0 * r, rho * 0.5, rho))
            u = u * (rho / rho_new)
            log.append([it, float(r), float(s), float(rho),
                        int((z_new != 0).sum()), int((z_new != z).sum())])
            z, rho = z_new, rho_new
            it += 1
        return beta, z, torch.maximum(r, s), torch.tensor(
            it, dtype=torch.int32, device=dev)

    return loop


def main():
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        sys.exit("chip_admm_probe.py needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from nums_tpu_torch.core import application_manager
    from nums_tpu_torch.models import fast_glm
    from nums_tpu_torch.models.glms import LogisticRegression

    log = []
    fast_glm._admm_loop = _recording_loop(log)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "rendezvous"), world_size=1, rank=0)
        try:
            app = application_manager.create(backend="mesh")
            application_manager.set_instance(app)
            for rows, steps in SETTINGS:
                X = cs._draw_mesh_x(torch, app, rows, cs.D_FULL)
                y, _ = cs.planted_labels(torch, app, X)
                log.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = LogisticRegression(
                    C=cs.MC_ADMM_ROWS_C / rows,
                    admm_rho=cs.MC_ADMM_RHO_ROWS * rows, solver="admm",
                    penalty="l1", tol=cs.MC_ADMM["tol"],
                    max_iter=steps).fit(X, y)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                z = torch.cat([cs._mc_whole(m.coef_.data), cs._mc_whole(
                    m.intercept_.data).reshape(1)]).double()
                kkt = cs._l1_kkt64(torch, cs._mc_local(X), cs._rows_like(
                    app, y, X).double(), z, cs._mc_whole(
                        m._lambda_vec.data).double())
                print(json.dumps({
                    "rows": rows, "steps": steps, "seconds": secs, **kkt,
                    "first_steps": log[:12], "last_steps": log[-3:],
                    "columns": "r, s, rho, nonzeros, changed"}), flush=True)
                del X, y, m
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    print(_smi())


def _smi():
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


if __name__ == "__main__":
    main()
