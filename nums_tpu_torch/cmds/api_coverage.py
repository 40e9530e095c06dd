"""API-surface coverage report of ``nums_tpu_torch.numpy``.

Counterpart of ``nums_tpu/cmds/api_coverage.py``, with its ``IGNORE`` and
``HOST_FALLBACK`` sets copied (the port imports nothing of the JAX
package). Reports, for each numpy module surface (numpy, numpy.random,
numpy.linalg, numpy.fft), how many callables the facade implements, how
many of those are host round trips, how many raise ``_not_implemented``
stubs, and the coverage percentage:

    python -m nums_tpu_torch.cmds.api_coverage --min numpy=100,numpy.fft=100
"""

import inspect

import numpy as np


IGNORE = {
    # Non-array utilities / deprecated / printing — not API-parity targets.
    "load", "save", "savez", "savetxt", "set_printoptions", "get_printoptions",
    "printoptions", "seterr", "geterr", "errstate", "deprecate",
    "disp", "info", "source", "who", "lookfor", "safe_eval",
    "getbufsize", "setbufsize", "shares_memory", "may_share_memory",
    "show_config", "show_runtime", "get_include", "add_docstring",
    "frompyfunc", "vectorize", "memmap",
    # numpy's bundled test runner (np.test / np.random.test / ...): a
    # pytest entry point, not an array API.
    "test",
}


# Functions implemented with a host-NumPy round trip (CPU-only algorithms
# and domains), the reference's list.
HOST_FALLBACK = {
    # NOT in this list (resolved on the device, one scalar host sync for
    # a count, ops/masking.py): where, nonzero, argwhere, flatnonzero,
    # unique, unique_all/_counts/_inverse/_values, intersect1d,
    # setdiff1d, setxor1d, union1d, compress, extract, trim_zeros,
    # bincount, hypergeometric.
    # roots/eig/eigvals: the general eigenproblem runs in host LAPACK.
    "roots", "eig", "eigvals",
    "bytes",
    # CPU-only domains (no TPU representation): datetime64 calendars,
    # np.matrix, nditer machinery, binary/text file parsing.
    "asmatrix", "busday_count", "busday_offset", "is_busday",
    "datetime_as_string", "datetime_data", "isnat", "nested_iters",
    "fromfile", "fromregex", "genfromtxt", "savez_compressed",
}


def _module_coverage(np_module, our_module):
    implemented, fallback, stubs, missing = [], [], [], []
    for name in sorted(dir(np_module)):
        if name.startswith("_") or name in IGNORE:
            continue
        np_obj = getattr(np_module, name)
        if not callable(np_obj) or inspect.isclass(np_obj):
            continue
        ours = getattr(our_module, name, None)
        if ours is None:
            missing.append(name)
        elif getattr(ours, "_nums_tpu_stub", False):
            stubs.append(name)
        elif name in HOST_FALLBACK:
            fallback.append(name)
        else:
            implemented.append(name)
    return implemented, fallback, stubs, missing


def coverage_report(percents=None, fallbacks=None):
    import nums_tpu_torch.numpy as nps

    sections = [
        ("numpy", np, nps),
        ("numpy.random", np.random, nps.random),
        ("numpy.linalg", np.linalg, nps.linalg),
        ("numpy.fft", np.fft, nps.fft),
    ]
    lines = []
    for name, np_mod, our_mod in sections:
        impl, fb, stubs, miss = _module_coverage(np_mod, our_mod)
        total = len(impl) + len(fb) + len(stubs) + len(miss)
        pct = 100.0 * (len(impl) + len(fb)) / total if total else 0.0
        if percents is not None:
            percents[name] = pct
        if fallbacks is not None:
            fallbacks[name] = len(fb)
        lines.append(
            f"{name}: implemented {len(impl) + len(fb)}/{total} "
            f"({pct:.1f}%; {len(fb)} via host fallback), "
            f"stubs {len(stubs)}, missing {len(miss)}"
        )
        if miss:
            lines.append(f"  missing: {', '.join(miss[:25])}"
                         + (" ..." if len(miss) > 25 else ""))
    return "\n".join(lines)


def main(argv=None):
    """CLI. ``--min numpy=100,numpy.fft=100`` turns the report into a
    gate: exit 1 if any module's coverage drops below its floor;
    ``--max-fallbacks numpy=13`` caps the host round trips."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m nums_tpu_torch.cmds.api_coverage")
    parser.add_argument(
        "--min", default=None,
        help="comma-separated module=min_percent floors; nonzero exit "
             "on regression",
    )
    parser.add_argument(
        "--max-fallbacks", default=None,
        help="comma-separated module=max_count CEILINGS on host "
             "fallbacks; nonzero exit if the count grows",
    )
    args = parser.parse_args(argv)
    percents, fallbacks = {}, {}
    print(coverage_report(percents, fallbacks))
    ok = True
    if args.min:
        for part in args.min.split(","):
            mod, floor = part.split("=")
            got = percents.get(mod.strip())
            if got is None or got < float(floor):
                print(f"FAIL: {mod} coverage {got and round(got, 1)}% "
                      f"< floor {floor}%")
                ok = False
    if args.max_fallbacks:
        for part in args.max_fallbacks.split(","):
            mod, ceil = part.split("=")
            got = fallbacks.get(mod.strip())
            if got is None or got > int(ceil):
                print(f"FAIL: {mod} host fallbacks {got} > ceiling "
                      f"{ceil}")
                ok = False
    if not ok:
        return 1
    if args.min or args.max_fallbacks:
        print("coverage floors OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
