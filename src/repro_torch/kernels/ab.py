"""Time a kernel built from this checkout against the same kernel built
from other sources, in turns, on one card; or time the host side of a
kernel wrapper's launch.

    python -m repro_torch.kernels.ab pareto_rank DIR [DIR ...]
    python -m repro_torch.kernels.ab flash_attention DIR [DIR ...]
    python -m repro_torch.kernels.ab wrapper

Each DIR holds another version's ``csrc`` files under the kernel's own file
names (for example the parent commit's, unpacked with ``git archive``) and
must export the same C entry with the same arguments.  Every library is
first checked against the kernel's plain version at every shape
(``pareto_rank`` exactly, ``flash_attention`` in float32 within 2e-5); a
shape a library refuses (a nonzero return code) is reported and not timed.
Then each round times every library once, in turns: ``REPS`` launches of
the C entry captured in one CUDA graph, replayed between CUDA events, so
the wrapper's Python is not in the number.  ``ptxas`` registers and spills
of each build are printed from the build log.

``wrapper`` times, on the host, the parts in which ways of handing a
launch its stream and device differ (``torch.cuda.current_stream(dev)
.cuda_stream`` or ``torch._C._cuda_getCurrentRawStream``; entering
``torch.cuda.device`` on every call or only off the current device), and
whole ``pareto_rank`` wrapper calls at the search path's pools.

Every reading is one JSON object a line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import time
from pathlib import Path

import torch

from .build import build_library

KERNELS = ("pareto_rank", "flash_attention")
REPS = 20
# (n, k, valid fraction): the search path's largest pool and the 8192 pool
PARETO_SHAPES = ((768, 4, 1.0), (8192, 4, 0.8))
# (B, Sq, Sk, H, KV, D, Dv, mask, window, tag), float32
FA_SHAPES = ((4, 1152, 1152, 25, 5, 64, 64, "window", 1024, "hymba prefill"),
             (1, 1024, 1024, 32, 8, 128, 128, "causal", 0, "head dim 128"),
             (1, 64, 64, 4, 4, 192, 128, "causal", 0, "MLA"),
             (1, 512, 512, 128, 128, 192, 128, "causal", 0,
              "deepseek-v2 width"))
FA_TOL = 2e-5


def emit(**row):
    print(json.dumps(row), flush=True)


def bind(name: str, sources):
    """Build ``sources`` and return (C entry, build log path)."""
    path = build_library(name, sources)
    lib = ctypes.CDLL(str(path))
    if name == "pareto_rank":
        fn = lib.pareto_rank_dominance_counts
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, path.with_suffix(".log")


def ptxas(log: Path) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) a build."""
    out, kernel, spill = [], None, (None, None)
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1))) + spill)
            kernel = None
    return out


def graph_ms(launch) -> float:
    """Device milliseconds per launch: REPS launches in one CUDA graph."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        launch()                                   # warm up off the graph
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
        for _ in range(REPS):
            launch()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def stream_now() -> int:
    return torch.cuda.current_stream().cuda_stream


def pareto_cases(fn):
    """Per shape: (label, launch, check) for one library."""
    from .pareto_rank.ref import dominance_counts_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n, k, frac in PARETO_SHAPES:
        objs = torch.randn(n, k, generator=gen, device="cuda")
        objs[n // 2:n // 2 + 16] = objs[:16]                 # exact ties
        valid = torch.rand(n, generator=gen, device="cuda") < frac
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        want = dominance_counts_ref(objs, valid)

        def launch(objs=objs, valid=valid, out=out, n=n, k=k):
            return fn(objs.data_ptr(), valid.data_ptr(), out.data_ptr(), n,
                      k, stream_now())

        def check(out=out, want=want):
            return dict(exact=bool(torch.equal(out, want)))
        cases.append((f"({n}, {k})", launch, check))
    return cases


def fa_cases(fn):
    from .flash_attention.ref import MASK_KINDS, attention_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for B, Sq, Sk, H, KV, D, Dv, mask, w, tag in FA_SHAPES:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
        k = torch.randn(B, Sk, KV, D, generator=gen, device="cuda")
        v = torch.randn(B, Sk, KV, Dv, generator=gen, device="cuda")
        out = torch.empty(B, Sq, H, Dv, device="cuda")
        want = attention_ref(q, k, v, mask, w, None)

        def launch(q=q, k=k, v=v, out=out, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV,
                   D=D, Dv=Dv, mask=mask, w=w):
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), 0, B, Sq, Sk, H, KV, D, Dv,
                      MASK_KINDS.index(mask), w, Sk, 0, stream_now())

        def check(out=out, want=want):
            diff = (out - want).abs()
            err = float(diff.max())
            ok = bool((diff <= FA_TOL + FA_TOL * want.abs()).all())
            return dict(max_abs_err=err, within_tol=ok)
        cases.append((f"{tag} {(B, Sq, Sk, H, KV, D, Dv, mask)}", launch,
                       check))
    return cases


def compare(kernel: str, dirs, rounds: int):
    here = Path(__file__).resolve().parent / kernel / "csrc"
    names = (("pareto_rank.cu",) if kernel == "pareto_rank" else
             ("flash_attention.cu", "flash_attention_wgmma.cu"))
    versions = {"this checkout": [here / f for f in names]}
    for d in dirs:
        versions[str(d)] = [Path(d) / f for f in names]
    make = pareto_cases if kernel == "pareto_rank" else fa_cases
    cases = {}
    for label, sources in versions.items():
        t0 = time.perf_counter()
        fn, log = bind(kernel, sources)
        emit(kernel=kernel, version=label, build_s=time.perf_counter() - t0,
             ptxas=ptxas(log))
        cases[label] = make(fn)
    timed = {}
    for label, cs in cases.items():
        for shape, launch, check in cs:
            rc = launch()
            torch.cuda.synchronize()
            if rc != 0:
                emit(kernel=kernel, version=label, shape=shape, refused=rc)
                continue
            verdict = check()
            emit(kernel=kernel, version=label, shape=shape, **verdict)
            if all(v for key, v in verdict.items() if key != "max_abs_err"):
                timed.setdefault(shape, []).append((label, launch))
    readings = {(s, lab): [] for s, ls in timed.items() for lab, _ in ls}
    for _ in range(rounds):
        for shape, ls in timed.items():
            for label, launch in ls:
                readings[(shape, label)].append(graph_ms(launch) * 1e3)
    for (shape, label), us in readings.items():
        emit(kernel=kernel, version=label, shape=shape, us_per_launch=us,
             min_us=min(us), max_us=max(us))


def host_us(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def wrapper(rounds: int):
    from .pareto_rank import ops
    dev = torch.device("cuda", torch.cuda.current_device())
    idle = contextlib.nullcontext()

    def public_stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def raw_stream():
        return torch._C._cuda_getCurrentRawStream(dev.index)

    def device_context():
        with torch.cuda.device(dev):
            pass

    def context_off_current():
        with (idle if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            pass

    parts = dict(public_stream=public_stream, raw_stream=raw_stream,
                 device_context=device_context,
                 context_off_current=context_off_current)
    pools = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, k in ((64, 2), (128, 2), (768, 4)):
        objs = torch.randn(n, k, generator=gen, device="cuda")
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        pools[f"dominance_counts ({n}, {k})"] = (
            lambda o=objs, v=valid: ops.dominance_counts(o, v))
    for fn in (*parts.values(), *pools.values()):
        fn()
    torch.cuda.synchronize()
    readings = {name: [] for name in (*parts, *pools)}
    for _ in range(rounds):
        for name, fn in parts.items():
            readings[name].append(host_us(fn, 100000))
        for name, fn in pools.items():
            readings[name].append(host_us(fn, 5000))
            torch.cuda.synchronize()
    for name, us in readings.items():
        emit(wrapper=name, host_us_per_call=us, min_us=min(us),
             max_us=max(us))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=KERNELS + ("wrapper",))
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab: needs a CUDA card")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    if args.what == "wrapper":
        wrapper(args.rounds)
    else:
        compare(args.what, args.dirs, args.rounds)


if __name__ == "__main__":
    main()
