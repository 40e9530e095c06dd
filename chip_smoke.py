"""Smoke run of nums_tpu_torch on one CUDA card.

    python3 chip_smoke.py                 # phases 1-6
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from nums_tpu_torch/csrc, timed; the gram
     kernel's SASS (cuobjdump) must hold tensor-core HGMMA instructions;
  3. each kernel against its plain torch version on the card, at small
     ragged shapes (d = 1, 97, 129, 1001, 1025; n not a multiple of any
     tile, and n < 64), in every rounding mode of the gram; the staged
     bf16 copy exactly as the plain rounding with a zero pad; two calls of
     each kernel bitwise equal;
  4. the main path at full size through the public entry points:
     init() -> random_state -> X.T @ X -> LogisticRegression(newton).fit
     -> predict, checked against float64 and plain-float32 references,
     with launch counts showing that it ran through the kernels, and its
     peak device memory;
  5. times on the card (CUDA events, median of 5 after warm-up), each
     kernel against its plain version at the main path's shapes, and the
     gram's staging pass alone;
  6. profile: torch.profiler over one 10-iteration fit, device time by
     kernel (the full table goes to standard error).
Then the kernels as one JSON line, and last
{"ok": true, "device": {...}}. A failed phase prints its traceback and
exits with 1, without that last line. No CUDA device: exits with 2.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

N_FULL, D_FULL = 2_500_000, 1000
DEVICE = "cuda"
# Kernel vs its plain version on identical inputs: the bf16 rounding is
# the same, only the order of the f32 sums differs. Relative to max|plain|.
SMALL_REL = 1e-5       # phase 3, sums of at most a few thousand rows
FULL_REL = 1e-3        # phase 5, f32 sums of 2.5M rows: the plain cuBLAS
                       # product alone is 1.3e-4 off the kernel there, and
                       # phase 5 reports each side against a float64 sum
BF16_REL = 2e-3        # gram vs a float64 gram (tests/core/ops/test_pallas_gram.py:11)
BETA_REL = 1e-2        # bf16-class fit vs plain-float32 fit, max|Δβ| / max|β|:
                       # eta uses bf16(β), which pins β only to about one
                       # bf16 ulp (2^-8 = 3.9e-3 relative)
ACC_SLACK = 0.01       # fitted accuracy vs the true β's accuracy
FIT = dict(solver="newton", tol=1e-8, max_iter=10)


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_err(got, ref):
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / max(scale, 1e-30)


def time_ms(fn, reps=5):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _sass_functions(path, nvcc):
    """{function name: SASS text} of a built library (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def phase_build():
    from nums_tpu_torch.core.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    secs = time.perf_counter() - t0
    for line in _build.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "warning" in line):
            print(line.strip(), file=sys.stderr)
    # Guard against a silent SIMT build: the gram must run on the tensor
    # cores, whose sm_90a instruction is HGMMA.
    funcs = _sass_functions(path, _build.nvcc_path())
    mma = [body for name, body in funcs.items() if "gram_mma" in name]
    assert len(mma) == 1, ("gram_mma in the SASS", sorted(funcs))
    hgmma = mma[0].count("HGMMA")
    assert hgmma > 0, "gram_mma's SASS holds no HGMMA instruction"
    emit({"phase": "build", "seconds": secs, "library": path.name,
          "gram_mma_hgmma_instructions": hgmma})


SMALL_SHAPES = [(1003, 97), (2049, 1001), (37, 1), (4099, 130), (5, 64),
                (64, 128), (65, 129), (130, 1025), (63, 1)]


def _check_stage(torch, cuda_gram, x, w, mode):
    """The staged copy is the plain rounding of Xᵀ, bit for bit, and zero
    in the pad."""
    n, d = x.shape
    xt = cuda_gram.stage(x, w, mode)
    ref = cuda_gram.stage_plain(x, w, mode).T.to(torch.bfloat16)
    assert torch.equal(xt[:d, :n], ref), ("staged copy", mode, n, d)
    assert not bool(xt[d:].any()) and not bool(xt[:, n:].any()), (
        "pad not zero", mode, n, d)


def phase_small(torch):
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    modes = (("gram", cuda_gram.MODE_X),
             ("gram_weighted", cuda_gram.MODE_SCALE_F32),
             ("gram_weighted_bf16_scale", cuda_gram.MODE_SCALE_BF16))
    worst = {name: 0.0 for name, _ in modes}
    worst["newton_stats"] = 0.0
    for n, d in SMALL_SHAPES:
        x = torch.randn(n, d, generator=gen, device=DEVICE)
        s = torch.rand(n, generator=gen, device=DEVICE)
        for name, mode in modes:
            w = None if mode == cuda_gram.MODE_X else s
            _check_stage(torch, cuda_gram, x, w, mode)
            g = cuda_gram.gram(x, w, mode)
            again = cuda_gram.gram(x, w, mode)
            p = cuda_gram.gram_plain(x, w, mode)
            torch.cuda.synchronize()
            err, rel = rel_err(g, p)
            assert torch.equal(g, again), (name, n, d, "not repeatable")
            assert torch.equal(g, g.T), (name, n, d, "not symmetric")
            assert rel <= SMALL_REL, (name, n, d, rel)
            worst[name] = max(worst[name], err)
        y = (torch.rand(n, generator=gen, device=DEVICE) > 0.5).float()
        beta = 0.05 * torch.randn(d, generator=gen, device=DEVICE)
        for kind in cuda_newton.KINDS:
            g, h = cuda_newton.stats(x, y, beta, kind)
            g2, h2 = cuda_newton.stats(x, y, beta, kind)
            pg, ph = cuda_newton.stats_plain(x, y, beta, kind)
            torch.cuda.synchronize()
            assert torch.equal(g, g2) and torch.equal(h, h2), (
                kind, n, d, "not repeatable")
            assert torch.equal(h, h.T), (kind, n, d, "H not symmetric")
            for got, ref, what in ((g, pg, "g"), (h, ph, "H")):
                err, rel = rel_err(got, ref)
                assert rel <= SMALL_REL, (kind, what, n, d, rel)
                worst["newton_stats"] = max(worst["newton_stats"], err)
    emit({"phase": "kernels_vs_plain_small", "shapes": SMALL_SHAPES,
          "tolerance_rel": SMALL_REL, "max_abs_err": worst})


def _gram64(x, chunk=1 << 18):
    import torch

    g = torch.zeros(x.shape[1], x.shape[1], dtype=torch.float64,
                    device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        g += c.T @ c
    return g


def _upper_pair_flops(n, d, tile=128):
    """Multiply-adds x 2 of the upper tile pairs the gram computes."""
    t = -(-d // tile)
    return 2.0 * n * (t * (t + 1) // 2) * tile * tile


def _reset_counts():
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    for counts in (cuda_gram.LAUNCHES, cuda_newton.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counts():
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    return {**cuda_gram.LAUNCHES, **cuda_newton.LAUNCHES}


def phase_main_path(torch):
    import nums_tpu_torch
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.models.glms import LogisticRegression

    app = nums_tpu_torch.init()
    assert app.backend.device.type == DEVICE, app.backend.device
    assert settings.matmul_precision == "default", settings.matmul_precision
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rs = app.random_state(1337)
    X = rs.normal(shape=(N_FULL, D_FULL), block_shape=(N_FULL, D_FULL),
                  dtype=np.float32)
    G = X.T @ X
    G.touch()
    gram_launches = _counts()["gram"]
    assert gram_launches >= 1, "X.T @ X did not launch the gram kernel"
    # Labels from a true beta with logistic noise (not separable).
    beta_true = rs.normal(scale=0.1, shape=(D_FULL,), dtype=np.float32)
    u = rs.uniform(shape=(N_FULL,), dtype=np.float32)
    eta = X @ beta_true
    y = (app.one / (app.one + app.exp(-eta)) > u).astype(np.float32)
    model = LogisticRegression(**FIT).fit(X, y)
    acc = float(model.score(X, y))
    main_secs = time.perf_counter() - t0
    counts = _counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    for k in ("newton_stats", "gram_weighted"):
        assert counts[k] >= 1, f"the fit did not launch {k}"

    g64 = _gram64(X.data)
    _, gram_rel = rel_err(G.data, g64)
    assert G.shape == (D_FULL, D_FULL) and bool(torch.isfinite(G.data).all())
    assert gram_rel <= BF16_REL, ("gram vs float64", gram_rel)
    assert torch.equal(G.data, G.data.T), "G not symmetric"
    del g64
    acc_true = float(((eta > 0).astype(np.float32) == y).mean())
    assert abs(acc - acc_true) <= ACC_SLACK, (acc, acc_true)
    beta_k = torch.cat([model.coef_.data, model.intercept_.data[None]])
    assert bool(torch.isfinite(beta_k).all())

    settings.matmul_precision = "highest"
    try:
        ref = LogisticRegression(**FIT).fit(X, y)
    finally:
        settings.matmul_precision = "default"
    beta_h = torch.cat([ref.coef_.data, ref.intercept_.data[None]])
    _, beta_rel = rel_err(beta_k, beta_h)
    assert beta_rel <= BETA_REL, ("beta: kernels vs highest", beta_rel)
    emit({"phase": "main_path", "shape": [N_FULL, D_FULL],
          "seconds": main_secs, "launches": counts,
          "max_memory_allocated_bytes": peak_bytes,
          "gram_rel_err_vs_f64": gram_rel, "gram_tolerance": BF16_REL,
          "accuracy": acc, "accuracy_true_beta": acc_true,
          "beta_rel_err_vs_highest": beta_rel, "beta_tolerance": BETA_REL})
    return app, X, y, model, counts


def phase_times(torch, smi, X, y, model):
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
    from nums_tpu_torch.models.glms import LogisticRegression

    out = {}
    x = X.data
    g, p = cuda_gram.gram(x), cuda_gram.gram_plain(x)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("gram at full size", rel)
    # Which side carries the f32 summation error: both against a float64
    # sum of the same bf16-rounded inputs.
    exact = _gram64(cuda_gram.round_bf16(x))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del g, p, exact
    out["gram"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(x)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(x)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(x)),
        "matmul_fp32_ms": time_ms(lambda: x.T @ x),
    }
    out["gram"]["upper_pair_tflops"] = (
        _upper_pair_flops(*x.shape) / out["gram"]["ms"] / 1e9)
    xa = torch.cat([x, torch.ones(x.shape[0], 1, device=x.device)], dim=1)
    del x
    beta = 0.5 * torch.cat([model.coef_.data, model.intercept_.data[None]])
    mu = torch.sigmoid(xa @ beta)
    s = mu * (1.0 - mu)
    g, p = cuda_gram.gram(xa, s), cuda_gram.gram_plain(xa, s)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("weighted gram at full size", rel)
    exact = _gram64(cuda_gram.stage_plain(xa, s))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del g, p, exact
    out["gram_weighted"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(xa, s)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(xa, s)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(xa, s)),
    }
    yd = y.data
    (g, h), (pg, ph) = (cuda_newton.stats(xa, yd, beta, "logistic"),
                        cuda_newton.stats_plain(xa, yd, beta, "logistic"))
    err_g, rel_g = rel_err(g, pg)
    err_h, rel_h = rel_err(h, ph)
    assert max(rel_g, rel_h) <= FULL_REL, ("stats at full size", rel_g, rel_h)
    del g, h, pg, ph
    out["newton_stats"] = {
        "max_abs_err": max(err_g, err_h), "rel_err": max(rel_g, rel_h),
        "ms": time_ms(lambda: cuda_newton.stats(xa, yd, beta, "logistic")),
        "stage_ms": time_ms(lambda: cuda_gram.stage(
            xa, s, cuda_gram.MODE_SCALE_BF16)),
        "plain_ms": time_ms(
            lambda: cuda_newton.stats_plain(xa, yd, beta, "logistic")
        ),
    }
    del xa, mu, s

    def fit():
        LogisticRegression(**FIT).fit(X, y)

    out["fit_10_iter"] = {"ms": time_ms(fit)}
    settings.matmul_precision = "highest"
    try:
        out["fit_10_iter"]["highest_ms"] = time_ms(fit)
    finally:
        settings.matmul_precision = "default"
    emit({"phase": "times", "card": smi, "shape": [N_FULL, D_FULL],
          "tolerance_rel": FULL_REL, "times": out})
    return out


def phase_profile(torch, X, y):
    """Device time by kernel over one 10-iteration fit (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from nums_tpu_torch.models.glms import LogisticRegression

    LogisticRegression(**FIT).fit(X, y)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        LogisticRegression(**FIT).fit(X, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    print(table, file=sys.stderr, flush=True)
    kernels = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            ms = e.device_time_total / 1e3
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_ms": busy,
          "idle_share": 1.0 - busy / wall_ms,
          "kernels_ms": dict(top)})


KERNELS = (
    ("gram", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:139"),
    ("gram_weighted", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:81"),
    ("newton_stats", "nums_tpu_torch/csrc/newton.cu",
     "nums_tpu/core/ops/pallas_newton.py:143"),
)


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        smi = phase_device(torch)
        phase_build()
        phase_small(torch)
        if "--kernels-only" in argv:
            return 0
        _, X, y, model, counts = phase_main_path(torch)
        times = phase_times(torch, smi, X, y, model)
        phase_profile(torch, X, y)
        kernels = [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": counts[name],
             "max_abs_err": times[name]["max_abs_err"],
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
            for name, src, rep in KERNELS
        ]
        emit({"kernels": kernels})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 - report any failed phase and exit 1
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
