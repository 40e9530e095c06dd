"""Smoke run of nums_tpu_torch on one CUDA card.

    python3 chip_smoke.py                 # phases 1-7
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from nums_tpu_torch/csrc, timed; the gram
     kernel's SASS (cuobjdump) must hold tensor-core HGMMA instructions,
     and the Newton passes' SASS 128-bit global loads (LDG.E.128);
  3. each kernel against its plain torch version on the card, at small
     ragged shapes (d = 1, 97, 129, 1001, 1025; n not a multiple of any
     tile, and n < 64), in every rounding mode of the gram; the staged
     bf16 copy exactly as the plain rounding with a zero pad; the Newton
     statistics on X and on X staged once, and their two passes
     (newton_eta, newton_grad_scale) apart, the scaled operand exactly
     as the plain rounding with a zero pad; two calls of each kernel
     bitwise equal;
  4. the main path at full size through the public entry points:
     init() -> random_state -> X.T @ X -> LogisticRegression(newton).fit
     -> predict, checked against float64 and plain-float32 references,
     with launch counts showing that it ran through the kernels (X staged
     once for the fit, the statistics once per iteration), and its peak
     device memory;
  5. times on the card (CUDA events, median of 5 after warm-up), each
     kernel against its plain version at the main path's shapes (K3 in
     each of its logistic, linear and Poisson kinds, on X staged once and
     on X, and its parts, each part also held to its plain version as in
     phase 3), the gram's staging pass alone, and the cuBLAS call that
     computes K1's and K2's function;
  6. profile: torch.profiler over one 10-iteration fit, device time by
     kernel (the full table goes to standard error), with the fit's
     launch counts and one staging pass;
  7. glm_families: the other GLM families and solvers on phase 4's X,
     each fit timed on the host clock and held to its check (the table
     in ``phase_glm_families``), with the launch counts of each fit
     (counts set to 0 just before it, read just after) and the peak
     device memory.
Then the kernels as one JSON line (each with its bound, the least time
the card could take for its work at this run's shapes), and last
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
# One H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12      # outside the tensor cores


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
    # The Newton passes are bound by memory: each must load 16 bytes a
    # thread (every instance of a template).
    wide = {}
    for kern in ("newton_eta", "newton_grad_scale"):
        bodies = [body for name, body in funcs.items() if kern in name]
        assert bodies, (kern, "not in the SASS", sorted(funcs))
        wide[kern] = [body.count("LDG.E.128") for body in bodies]
        assert all(wide[kern]), f"{kern}'s SASS holds no LDG.E.128"
    emit({"phase": "build", "seconds": secs, "library": path.name,
          "gram_mma_hgmma_instructions": hgmma,
          "ldg_e_128_instructions": wide})


SMALL_SHAPES = [(1003, 97), (2049, 1001), (37, 1), (4099, 130), (5, 64),
                (64, 128), (65, 129), (130, 1025), (63, 1)]


def _check_xt(torch, xt, ref, what):
    """A staged bf16 copy (d_pad, n_pad) is ``ref`` (n, d, float32)
    transposed, bit for bit, and zero in the pad."""
    n, d = ref.shape
    assert torch.equal(xt[:d, :n], ref.T.to(torch.bfloat16)), (what, n, d)
    assert not bool(xt[d:].any()) and not bool(xt[:, n:].any()), (
        "pad not zero", what, n, d)


def _check_stage(torch, cuda_gram, x, w, mode):
    """The staged copy is the plain rounding of Xᵀ."""
    _check_xt(torch, cuda_gram.stage(x, w, mode),
              cuda_gram.stage_plain(x, w, mode), ("staged copy", mode))


def _check_newton_parts(torch, cuda_gram, cuda_newton, x, staged, y, beta,
                        kind, g_rel):
    """newton_eta and newton_grad_scale on ``staged`` (X staged once),
    each against its plain version on the same inputs, twice bitwise
    equal; the scaled operand is the plain mode-2 rounding with the
    kernel's own weight, zero in the pad. eta is a sum over one row, held
    to SMALL_REL at every size; g sums all n rows, held to ``g_rel``.
    Returns the largest absolute errors of (eta, g)."""
    n = x.shape[0]
    rb, wb = cuda_newton.eta(staged, y, beta, kind)
    again = cuda_newton.eta(staged, y, beta, kind)
    xb = cuda_gram.round_bf16(x)
    plain = cuda_newton.eta_plain(xb, y, beta, kind)
    eta_err = 0.0
    for got, twice, ref in zip((rb, wb), again, plain):
        if ref is None:
            assert got is None and twice is None, kind
            continue
        assert torch.equal(got, twice), (kind, "newton_eta not repeatable")
        assert not bool(got[n:].any()), (kind, "newton_eta pad not zero")
        err, rel = rel_err(got[:n], ref)
        assert rel <= SMALL_REL, (kind, "newton_eta", x.shape, rel)
        eta_err = max(eta_err, err)
    del again, plain
    g, xs = cuda_newton.grad_scale(staged, rb, wb)
    g2, xs2 = cuda_newton.grad_scale(staged, rb, wb)
    pg, _ = cuda_newton.grad_scale_plain(xb, rb[:n].float(), None)
    del xb
    torch.cuda.synchronize()
    assert torch.equal(g, g2), (kind, "newton_grad_scale not repeatable")
    g_err, rel = rel_err(g, pg)
    assert rel <= g_rel, (kind, "newton_grad_scale g", x.shape, rel)
    if wb is None:
        assert xs is None and xs2 is None, kind
        return eta_err, g_err
    assert torch.equal(xs, xs2), (kind, "scaled operand not repeatable")
    del xs2
    # sqrt(w²) = w exactly for a bf16 w, so this is bf16(bf16(x)·w).
    w = wb[:n].float()
    _check_xt(torch, xs, cuda_gram.stage_plain(
        x, w * w, cuda_gram.MODE_SCALE_BF16), ("scaled operand", kind))
    return eta_err, g_err


def phase_small(torch):
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    modes = (("gram", cuda_gram.MODE_X),
             ("gram_weighted", cuda_gram.MODE_SCALE_F32),
             ("gram_weighted_bf16_scale", cuda_gram.MODE_SCALE_BF16))
    worst = {name: 0.0 for name, _ in modes}
    worst.update(newton_stats=0.0, newton_eta=0.0, newton_grad_scale=0.0)
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
        staged = cuda_newton.prepare(x)
        assert torch.equal(staged.xt, cuda_newton.prepare_plain(x).xt), (
            "prepare", n, d)
        for kind in cuda_newton.KINDS:
            pg, ph = cuda_newton.stats_plain(x, y, beta, kind)
            for form, arg in (("x", x), ("staged", staged)):
                g, h = cuda_newton.stats(arg, y, beta, kind)
                g2, h2 = cuda_newton.stats(arg, y, beta, kind)
                torch.cuda.synchronize()
                assert torch.equal(g, g2) and torch.equal(h, h2), (
                    kind, form, n, d, "not repeatable")
                assert torch.equal(h, h.T), (kind, form, n, d,
                                             "H not symmetric")
                for got, ref, what in ((g, pg, "g"), (h, ph, "H")):
                    err, rel = rel_err(got, ref)
                    assert rel <= SMALL_REL, (kind, form, what, n, d, rel)
                    worst["newton_stats"] = max(worst["newton_stats"], err)
            eta_err, g_err = _check_newton_parts(
                torch, cuda_gram, cuda_newton, x, staged, y, beta, kind,
                SMALL_REL)
            worst["newton_eta"] = max(worst["newton_eta"], eta_err)
            worst["newton_grad_scale"] = max(worst["newton_grad_scale"],
                                             g_err)
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
    """Multiply-adds x 2 of the upper tile pairs the gram kernel computes,
    its zero pad included: the rate it runs at."""
    t = -(-d // tile)
    return 2.0 * n * (t * (t + 1) // 2) * tile * tile


def _triangle_flops(n, d):
    """Multiply-adds x 2 of the gram's upper triangle, its diagonal
    included: the work the function needs, for its bound."""
    return 1.0 * n * d * (d + 1)


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
    # The fit stages X once and runs the statistics (and their weighted
    # gram) once per iteration: newton_fit runs all max_iter steps.
    assert counts["newton_stage"] == 1, counts
    assert counts["newton_stats"] == FIT["max_iter"], counts
    assert counts["gram_weighted"] == FIT["max_iter"], counts

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
    return app, X, y, model, counts, ref


def _bound(bytes_moved, tc_flops, f32_flops=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate
    and the operations of each type over that type's peak rate (the
    tensor cores and the f32 units run side by side)."""
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(tc_flops / BF16_TC_FLOPS, f32_flops / F32_FLOPS) * 1e3
    return max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations"


def _library_gram(torch):
    """(fn, what): cuBLAS's gram of bf16 operands, float32 out where this
    torch's mm takes ``out_dtype``, else bf16 out. The port never calls
    it; it is the yardstick of K1 and K2."""
    probe = torch.ones(64, 64, device=DEVICE, dtype=torch.bfloat16)
    try:
        torch.mm(probe, probe, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda a: torch.mm(a.T, a)), "torch.mm, bf16 output"
    return ((lambda a: torch.mm(a.T, a, out_dtype=torch.float32)),
            "torch.mm(out_dtype=float32)")


def _time_k3(torch, cuda_gram, cuda_newton, xa, staged, yd, beta, kind):
    """K3 of one kind at full size: held to its plain version, the staged
    and one-shot forms bitwise equal, each part held to its plain version
    as in phase 3 (g to FULL_REL), and the times of both forms, the plain
    version and each part."""
    g, h = cuda_newton.stats(staged, yd, beta, kind)
    g1, h1 = cuda_newton.stats(xa, yd, beta, kind)
    assert torch.equal(g, g1) and torch.equal(h, h1), (kind, "forms differ")
    del g1, h1
    pg, ph = cuda_newton.stats_plain(xa, yd, beta, kind)
    err_g, rel_g = rel_err(g, pg)
    err_h, rel_h = rel_err(h, ph)
    assert max(rel_g, rel_h) <= FULL_REL, ("stats at full size", kind,
                                            rel_g, rel_h)
    del g, h, pg, ph
    eta_err, grad_err = _check_newton_parts(
        torch, cuda_gram, cuda_newton, xa, staged, yd, beta, kind, FULL_REL)
    rb, wb = cuda_newton.eta(staged, yd, beta, kind)
    _, xs = cuda_newton.grad_scale(staged, rb, wb)
    hx = staged.xt if xs is None else xs
    out = {
        "max_abs_err": max(err_g, err_h), "rel_err": max(rel_g, rel_h),
        "newton_eta_max_abs_err": eta_err,
        "newton_grad_scale_max_abs_err": grad_err,
        "ms": time_ms(lambda: cuda_newton.stats(staged, yd, beta, kind)),
        "one_shot_ms": time_ms(lambda: cuda_newton.stats(xa, yd, beta,
                                                         kind)),
        "plain_ms": time_ms(
            lambda: cuda_newton.stats_plain(xa, yd, beta, kind)),
        "newton_eta_ms": time_ms(
            lambda: cuda_newton.eta(staged, yd, beta, kind)),
        "newton_grad_scale_ms": time_ms(
            lambda: cuda_newton.grad_scale(staged, rb, wb)),
        "gram_ms": time_ms(
            lambda: cuda_gram.gram_staged(hx, staged.d, xs is not None)),
    }
    del rb, wb, xs, hx
    return out


def phase_times(torch, smi, X, y, model):
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
    from nums_tpu_torch.models.glms import LogisticRegression

    out = {}
    lib_gram, lib_what = _library_gram(torch)
    x = X.data
    n, d = x.shape
    g, p = cuda_gram.gram(x), cuda_gram.gram_plain(x)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("gram at full size", rel)
    # Which side carries the f32 summation error: both against a float64
    # sum of the same bf16-rounded inputs.
    exact = _gram64(cuda_gram.round_bf16(x))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del p, exact
    _, lib_rel = rel_err(lib_gram(x.to(torch.bfloat16)).float(), g)
    del g
    out["gram"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(x)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(x)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(x)),
        "matmul_fp32_ms": time_ms(lambda: x.T @ x),
        "library_ms": time_ms(lambda: lib_gram(x.to(torch.bfloat16))),
        "library_call": lib_what, "library_rel_err_vs_kernel": lib_rel,
    }
    out["gram"]["upper_pair_tflops"] = (
        _upper_pair_flops(n, d) / out["gram"]["ms"] / 1e9)
    out["gram"]["bound_ms"], out["gram"]["bound_by"] = _bound(
        4.0 * n * d + 4.0 * d * d, _triangle_flops(n, d))
    xa = torch.cat([x, torch.ones(n, 1, device=x.device)], dim=1)
    del x
    da = d + 1
    beta = 0.5 * torch.cat([model.coef_.data, model.intercept_.data[None]])
    mu = torch.sigmoid(xa @ beta)
    s = mu * (1.0 - mu)
    del mu
    g, p = cuda_gram.gram(xa, s), cuda_gram.gram_plain(xa, s)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("weighted gram at full size", rel)
    exact = _gram64(cuda_gram.stage_plain(xa, s))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del p, exact

    def scaled_bf16():
        return (xa * s.sqrt()[:, None]).to(torch.bfloat16)

    _, lib_rel = rel_err(lib_gram(scaled_bf16()).float(), g)
    del g
    out["gram_weighted"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(xa, s)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(xa, s)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(xa, s)),
        "library_ms": time_ms(lambda: lib_gram(scaled_bf16())),
        "library_call": lib_what, "library_rel_err_vs_kernel": lib_rel,
    }
    out["gram_weighted"]["bound_ms"], out["gram_weighted"]["bound_by"] = (
        _bound(4.0 * n * da + 4.0 * n + 4.0 * da * da,
               _triangle_flops(n, da)))
    yd = y.data
    # K3: X staged once, as a fit stages it; the parts of a call, and the
    # cuBLAS sequence of the same steps (no one library call computes
    # K3's function, so it has no library time: context only).
    staged = cuda_newton.prepare(xa)
    out["newton_stats"] = _time_k3(torch, cuda_gram, cuda_newton, xa,
                                   staged, yd, beta, "logistic")
    out["newton_stats"]["stage_ms"] = time_ms(
        lambda: cuda_newton.prepare(xa))
    # K3's bound, for the call its "ms" times: it reads the staged bf16 Xᵀ
    # (2 bytes a value), y and beta, writes g and H; the gram's triangle
    # on the tensor cores, eta's and g's 4·n·d on the f32 units. The
    # one-shot call reads the fp32 X (4 bytes a value) instead.
    k3_rest = 4.0 * n + 8.0 * da + 4.0 * da * da
    k3_ops = (_triangle_flops(n, da), 4.0 * n * da)
    out["newton_stats"]["bound_ms"], out["newton_stats"]["bound_by"] = (
        _bound(2.0 * n * da + k3_rest, *k3_ops))
    out["newton_stats"]["one_shot_bound_ms"], _ = _bound(
        4.0 * n * da + k3_rest, *k3_ops)
    xb = xa.to(torch.bfloat16)

    def cublas_sequence():
        mu = torch.sigmoid((xb @ beta.to(torch.bfloat16)).float())
        w = (mu * (1.0 - mu)).sqrt().to(torch.bfloat16)
        xb.T @ (mu - yd).to(torch.bfloat16)
        return lib_gram(xb * w[:, None])

    out["newton_stats"]["cublas_sequence_ms"] = time_ms(cublas_sequence)
    del xb, s
    # The linear and Poisson kinds of K3 (phase 7's fused fits), at a
    # Poisson-sized beta: eta ~ N(0, 0.25), as phase 7 plants it.
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    beta_p = (0.5 / D_FULL ** 0.5) * torch.randn(
        da, generator=gen, device=DEVICE)
    for kind in ("linear", "poisson"):
        out[f"newton_stats_{kind}"] = _time_k3(
            torch, cuda_gram, cuda_newton, xa, staged, yd, beta_p, kind)
    del xa, staged

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
    """Device time by kernel over one 10-iteration fit (torch.profiler),
    and the fit's launch counts (set to 0 just before it, read just
    after); returns the counts."""
    from torch.profiler import ProfilerActivity, profile

    from nums_tpu_torch.models.glms import LogisticRegression

    LogisticRegression(**FIT).fit(X, y)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        LogisticRegression(**FIT).fit(X, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    print(table, file=sys.stderr, flush=True)
    kernels, calls = {}, {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            ms = e.device_time_total / 1e3
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
            calls[e.name] = calls.get(e.name, 0) + 1
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    stage_calls = sum(c for k, c in calls.items() if "gram_stage" in k)
    assert stage_calls == 1, ("one staging pass per fit", calls)
    emit({"phase": "profile", "wall_ms": wall_ms, "device_ms": busy,
          "idle_share": 1.0 - busy / wall_ms,
          "kernels_ms": dict(top),
          "kernel_calls": {k: calls[k] for k, _ in top},
          "gram_stage_calls": stage_calls, "launches": counts})
    return counts


# Phase 7, on phase 4's X (2.5M x 1000 fp32, the reference's size):
FAM_SEED = 2024
FAM_FIT = dict(tol=1e-8, max_iter=10)  # the fused fits and their refits
EAGER_LINEAR_ITERS = 3   # tol 0: every iteration runs, one K1 launch each
EXP_FIT = dict(tol=1e-8, max_iter=8)
EXP_ABS = 0.01           # exponential fit vs its planted beta, absolute
R2_ABS = 1e-3            # R² of the kernel fit vs the "highest" fit
# Lasso: alpha about 16x the noise's correlation with a column, σ/√n =
# 6.3e-5, so the 980 planted zeros stay exactly zero; float32 ADMM stops
# at max|β - z|, ρ·max|Δz| <= tol, against a float64 ADMM on the float64
# moments of the same X.
LASSO = dict(alpha=1e-3, tol=1e-4, max_iter=500)
LASSO_REF = dict(tol=1e-7, max_iter=3000)
# BFGS stops on max|g| < tol (g is O(1e5) at beta = 0) or on a line
# search that runs out of float32 digits; irls runs all its iterations.
LBFGS = dict(penalty="l2", tol=1.0, max_iter=100)
IRLS = dict(tol=1e-8, max_iter=10)
SOLVER_REL = 1e-3        # Lasso, lbfgs, irls vs their references


def _beta_of(torch, model):
    return torch.cat([model.coef_.data, model.intercept_.data[None]])


def _timed_fit(torch, make, X, y):
    """(model, seconds, launches, peak device bytes) of
    ``make().fit(X, y)``: the counts are set to 0 just before the fit and
    read just after it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model = make().fit(X, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return model, secs, _counts(), torch.cuda.max_memory_allocated()


def _highest(torch, make, X, y):
    """The same fit with plain fp32 ops (no kernel)."""
    from nums_tpu_torch.core import settings

    settings.matmul_precision = "highest"
    try:
        model, secs, counts, _ = _timed_fit(torch, make, X, y)
    finally:
        settings.matmul_precision = "default"
    assert not any(counts.values()), ("highest launched a kernel", counts)
    return model, secs


def _targets(torch, X):
    """Phase 7's labels from planted coefficients, drawn from generators
    seeded here: linear, Poisson (eta ~ N(0, 0.25)), exponential on the
    same eta, and sparse linear (20 nonzeros)."""
    n, d = X.shape
    x = X.data
    gen = torch.Generator(device=DEVICE).manual_seed(FAM_SEED)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    w_lin = 0.1 * normal(d)
    y_lin = x @ w_lin + 0.5 + 0.1 * normal(n)
    w_p = (0.5 / d ** 0.5) * normal(d)
    mu = torch.exp(x @ w_p)
    y_p = torch.poisson(mu, generator=gen)
    y_e = mu * torch.empty_like(mu).exponential_(1.0, generator=gen)
    del mu
    support = torch.randperm(
        d, generator=torch.Generator().manual_seed(FAM_SEED))[:20]
    w_s = torch.zeros(d, device=DEVICE)
    w_s[support.to(DEVICE)] = (
        (0.5 + 0.5 * torch.rand(20, generator=gen, device=DEVICE))
        * torch.where(normal(20) < 0, -1.0, 1.0))
    y_s = x @ w_s + 0.3 + 0.1 * normal(n)
    return (w_lin, y_lin), (w_p, y_p, y_e), (w_s, y_s)


def _moments64(torch, x, y, chunk=1 << 18):
    """[X, 1]ᵀ[X, 1] and [X, 1]ᵀy summed in float64, in row panels."""
    d = x.shape[1] + 1
    G = torch.zeros(d, d, dtype=torch.float64, device=x.device)
    q = torch.zeros(d, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        c = torch.cat([c, torch.ones(c.shape[0], 1, dtype=c.dtype,
                                     device=c.device)], dim=1)
        G += c.T @ c
        q += c.T @ y[i:i + chunk].double()
    return G, q


def phase_glm_families(torch, app, X, y, logistic_ref):
    """Every GLM family and solver beside phase 4's, at "default"
    precision, each held to its check:

    | fit                              | route            | must launch   |
    |----------------------------------|------------------|---------------|
    | LinearRegression(newton)         | fused, K3 linear | newton_stats  |
    | Ridge(alpha=1)                   | fused, K3 linear | newton_stats  |
    | LinearRegression, glm_fuse "0"   | eager, K1        | gram = iters  |
    | PoissonRegression(newton)        | fused, K3 poisson| newton_stats, |
    |                                  |                  | gram_weighted |
    | ExponentialRegression(newton)    | eager, plain ops |               |
    | Lasso(alpha=1e-3)                | ADMM, plain ops  |               |
    | LogisticRegression(lbfgs, l2)    | BFGS, plain ops  |               |
    | LogisticRegression(irls)         | eager, plain ops |               |
    """
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.models import fast_glm
    from nums_tpu_torch.models.glms import (
        ExponentialRegression, Lasso, LinearRegression, LogisticRegression,
        PoissonRegression, Ridge,
    )

    (w_lin, y_lin), (w_p, y_p, y_e), (w_s, y_s) = _targets(torch, X)
    n = X.shape[0]

    def ba(t):
        return BlockArray.from_torch(t, block_shape=(n,), backend=app.backend)

    fits = {}

    def record(name, fit, **checks):
        _, secs, counts, peak = fit
        fits[name] = {"seconds": secs, "launches": counts,
                      "peak_bytes": peak, **checks}
        print(json.dumps({name: fits[name]}), file=sys.stderr, flush=True)

    # Linear and Ridge, fused: K3's linear kind.
    by = ba(y_lin)
    lin_models = {}
    for name, make in (
        ("linear_newton", lambda: LinearRegression(solver="newton",
                                                   **FAM_FIT)),
        ("ridge", lambda: Ridge(alpha=1.0, **FAM_FIT)),
    ):
        fit = _timed_fit(torch, make, X, by)
        model, _, counts, _ = fit
        assert counts["newton_stage"] == 1, (name, counts)
        assert counts["newton_stats"] == counts["gram"] == FAM_FIT[
            "max_iter"], (name, counts)
        ref, ref_secs = _highest(torch, make, X, by)
        _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
        r2, r2_ref = float(model.score(X, by)), float(ref.score(X, by))
        assert rel <= BETA_REL, (name, "beta vs highest", rel)
        assert abs(r2 - r2_ref) <= R2_ABS, (name, r2, r2_ref)
        if name == "ridge":
            assert float(model._lambda_vec.data[-1]) == 0.0
        lin_models[name] = model
        record(name, fit, highest_seconds=ref_secs,
               beta_rel_err_vs_highest=rel, r2=r2, r2_highest=r2_ref)

    # Linear, eager Newton: X.T @ X through K1 at 2.5M x 1001, once per
    # iteration (the iterations are counted at the solve).
    solves = []
    solve = app.posdef_solve
    app.posdef_solve = lambda A, b: solves.append(1) or solve(A, b)
    settings.glm_fuse = "0"
    try:
        fit = _timed_fit(
            torch, lambda: LinearRegression(
                solver="newton", tol=0.0, max_iter=EAGER_LINEAR_ITERS),
            X, by)
    finally:
        settings.glm_fuse = "1"
        del app.posdef_solve
    model, _, counts, _ = fit
    assert counts["gram"] == len(solves) == EAGER_LINEAR_ITERS, (
        counts, len(solves))
    assert counts["newton_stats"] == 0, counts
    _, rel = rel_err(_beta_of(torch, model),
                     _beta_of(torch, lin_models["linear_newton"]))
    assert rel <= BETA_REL, ("eager vs fused linear", rel)
    record("linear_eager_newton", fit, iterations=len(solves),
           beta_rel_err_vs_fused=rel)

    # Poisson, fused: K3's Poisson kind.
    byp = ba(y_p)

    def make():
        return PoissonRegression(solver="newton", **FAM_FIT)

    fit = _timed_fit(torch, make, X, byp)
    model, _, counts, _ = fit
    assert counts["newton_stage"] == 1, counts
    assert counts["newton_stats"] == counts["gram_weighted"] == FAM_FIT[
        "max_iter"], counts
    ref, ref_secs = _highest(torch, make, X, byp)
    _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
    assert rel <= BETA_REL, ("poisson beta vs highest", rel)
    dev = float(model.deviance(byp, model.predict(X)))
    assert np.isfinite(dev) and dev >= 0.0, dev
    record("poisson_newton", fit, highest_seconds=ref_secs,
           beta_rel_err_vs_highest=rel, deviance=dev)
    del byp

    # Exponential, eager Newton on plain ops: the planted beta.
    fit = _timed_fit(
        torch, lambda: ExponentialRegression(solver="newton", **EXP_FIT),
        X, ba(y_e))
    model = fit[0]
    err = max(float((model.coef_.data - w_p).abs().max()),
              abs(float(model.intercept_.data)))
    assert err <= EXP_ABS, ("exponential vs planted beta", err)
    record("exponential_newton", fit, max_abs_err_vs_planted=err)

    # Lasso by ADMM, against a float64 ADMM on float64 moments.
    bys = ba(y_s)
    fit = _timed_fit(torch, lambda: Lasso(**LASSO), X, bys)
    model = fit[0]
    G, q = _moments64(torch, X.data, y_s)
    z, _, ref_it = fast_glm.admm_fit_gram(
        G, q, torch.zeros_like(q), LASSO_REF["tol"],
        max_iter=LASSO_REF["max_iter"], penalty="l1",
        lambda_vec=model._lambda_vec.data.double())
    del G
    _, rel = rel_err(_beta_of(torch, model), z)
    coef = model.coef_.data
    planted_zeros_exact = bool((coef[w_s == 0] == 0).all())
    assert rel <= SOLVER_REL, ("lasso vs float64 admm", rel)
    assert planted_zeros_exact, "a planted zero of the lasso is not 0"
    record("lasso_admm", fit, beta_rel_err_vs_f64_admm=rel,
           f64_admm_iterations=int(ref_it),
           nonzeros=int((coef != 0).sum()),
           planted_zeros_exact=planted_zeros_exact)
    del bys

    # Logistic by BFGS (l2) and by IRLS, against the fused Newton at
    # "highest" (phase 4's unpenalized fit for IRLS).
    searches = []
    search = fast_glm._line_search
    fast_glm._line_search = lambda *a: searches.append(1) or search(*a)
    try:
        fit = _timed_fit(
            torch, lambda: LogisticRegression(solver="lbfgs", **LBFGS), X, y)
    finally:
        fast_glm._line_search = search
    model = fit[0]
    ref, ref_secs = _highest(
        torch, lambda: LogisticRegression(solver="newton", penalty="l2",
                                          **FAM_FIT), X, y)
    _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
    assert rel <= SOLVER_REL, ("lbfgs vs newton", rel)
    record("logistic_lbfgs_l2", fit, iterations=len(searches),
           newton_highest_seconds=ref_secs, beta_rel_err_vs_newton=rel)
    fit = _timed_fit(
        torch, lambda: LogisticRegression(solver="irls", **IRLS), X, y)
    _, rel = rel_err(_beta_of(torch, fit[0]), _beta_of(torch, logistic_ref))
    assert rel <= SOLVER_REL, ("irls vs newton", rel)
    record("logistic_irls", fit, beta_rel_err_vs_newton=rel)

    emit({"phase": "glm_families", "shape": [N_FULL, D_FULL],
          "max_memory_allocated_bytes": max(
              f["peak_bytes"] for f in fits.values()),
          "fits": fits})
    return fits


KERNELS = (
    ("gram", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:139"),
    ("gram_weighted", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:81"),
    ("newton_stats", "nums_tpu_torch/csrc/newton.cu",
     "nums_tpu/core/ops/pallas_newton.py:143"),
)


def kernels_line(counts, fit_counts, times):
    """One entry per kernel: "launches" counts the main path (phase 4),
    "launches_per_fit" one fit (phase 6). gram.cu's weighted launches
    ("gram_weighted") on these paths are K3's Hessian."""
    return [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "launches_per_fit": fit_counts[name],
         "max_abs_err": times[name]["max_abs_err"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms")}
        for name, src, rep in KERNELS
    ]


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
        app, X, y, model, counts, ref = phase_main_path(torch)
        times = phase_times(torch, smi, X, y, model)
        fit_counts = phase_profile(torch, X, y)
        phase_glm_families(torch, app, X, y, ref)
        emit({"kernels": kernels_line(counts, fit_counts, times)})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 - report any failed phase and exit 1
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
