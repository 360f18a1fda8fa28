"""Time a kernel built from this checkout against the same kernel built
from other sources, in turns, on one card; or time the host side of a
kernel wrapper's launch.

    python -m repro_torch.kernels.ab pareto_rank DIR [DIR ...]
    python -m repro_torch.kernels.ab flash_attention DIR [DIR ...]
    python -m repro_torch.kernels.ab flash_attention_bwd DIR [DIR ...]
    python -m repro_torch.kernels.ab mamba_scan DIR [DIR ...]
    python -m repro_torch.kernels.ab mamba_scan_bwd DIR [DIR ...]
    python -m repro_torch.kernels.ab wrapper
    python -m repro_torch.kernels.ab evaluate ROOT [ROOT ...]

Each DIR holds another version's ``csrc`` files under the kernel's own file
names (for example the parent commit's, unpacked with ``git archive``) and
must export the same C entry with the same arguments: for
``flash_attention`` the forward, ``flash_attention_fwd``, built from
``flash_attention.cu`` and ``flash_attention_wgmma.cu`` (and
``flash_attention_tf32.cu``, the float32 tensor-core kernels, where the DIR
has it); for ``flash_attention_bwd`` the backward entry of the same name,
built from those and ``flash_attention_bwd.cu`` (and
``flash_attention_bwd_wgmma.cu`` and ``flash_attention_bwd_tf32.cu`` where
the DIR has them); for ``mamba_scan`` the forward
``mamba_selective_scan`` and for ``mamba_scan_bwd`` the backward
``mamba_selective_scan_bwd``, both built from ``mamba_scan.cu`` and
``mamba_scan_bwd.cu`` (a backward without ``mamba_scan_bwd_split`` takes h0
and plans its own launch where this checkout's takes the forward's chunk
states and the plan of ``mamba_scan_bwd_split``).  Every library is
first checked against the kernel's plain version at every shape
(``pareto_rank`` exactly; ``flash_attention`` in float32 within 2e-5 and in
bfloat16 within the serving tolerance, atol 4e-3 and rtol 8e-3; the
attention backward in float32 within 3e-5 of the plain backward and in
bfloat16 within ``tc_bwd_agreement``'s gate of
``flash_attention_bwd_tc_mirror``; the scan forward and backward within
1e-4) and against the first version's output (bit for bit, and the largest
elementwise difference); a shape a library refuses (a nonzero return
code) is reported and not timed.  Then each round times every library
once, in turns: ``REPS`` launches of the C entry captured in one CUDA
graph, replayed between CUDA events, so the wrapper's Python is not in the
number.  ``ptxas`` registers and spills of each build are printed from the
build log.

``wrapper`` times, on the host, the parts in which ways of handing a
launch its stream and device differ (``torch.cuda.current_stream(dev)
.cuda_stream`` or ``torch._C._cuda_getCurrentRawStream``; entering
``torch.cuda.device`` on every call or only off the current device), and
whole ``pareto_rank`` wrapper calls at the search path's pools.

``evaluate`` times one evaluation of the NSGA main path's population (64
random designs of the Fig. 4a transformer block, ``ch_max=4``) with this
checkout's ``src/`` and with each ROOT's (another checkout, e.g. the parent
commit unpacked with ``git archive``), each in its own process, in turns
(this checkout, the ROOTs, then the same in reverse order, a round); it
also counts the repeated evaluations whose metrics differ in any bit from
the first.

Every reading is one JSON object a line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from .build import build_library

KERNELS = ("pareto_rank", "flash_attention", "flash_attention_bwd",
           "mamba_scan", "mamba_scan_bwd")
# the library each mode builds, and the C sources it takes from a DIR (the
# optional ones where the DIR has them)
SOURCES = {"pareto_rank": ("pareto_rank", ("pareto_rank.cu",), ()),
           "flash_attention": ("flash_attention", (
               "flash_attention.cu", "flash_attention_wgmma.cu"),
               ("flash_attention_tf32.cu",)),
           "flash_attention_bwd": ("flash_attention", (
               "flash_attention.cu", "flash_attention_wgmma.cu",
               "flash_attention_bwd.cu"), ("flash_attention_tf32.cu",
                                           "flash_attention_bwd_wgmma.cu",
                                           "flash_attention_bwd_tf32.cu")),
           "mamba_scan": ("mamba_scan", ("mamba_scan.cu",
                                         "mamba_scan_bwd.cu"), ()),
           "mamba_scan_bwd": ("mamba_scan", ("mamba_scan.cu",
                                             "mamba_scan_bwd.cu"), ())}
REPS = 20
# (n, k, valid fraction): the search path's largest pool and the 8192 pool
PARETO_SHAPES = ((768, 4, 1.0), (8192, 4, 0.8))
# (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid_len, dtype, tag): the
# float32 shapes (the prefills, and the decode steps and cross-attention
# that the key-split kernel serves), then the bfloat16 serving shapes
# (Hymba's prefill, internlm2's prefill into a longer cache and its decode
# step, MLA decode)
FA_SHAPES = ((4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None, "float32",
              "hymba prefill"),
             (1, 1024, 1024, 32, 8, 128, 128, "causal", 0, None, "float32",
              "head dim 128"),
             (1, 64, 64, 4, 4, 192, 128, "causal", 0, None, "float32", "MLA"),
             (1, 512, 512, 128, 128, 192, 128, "causal", 0, None, "float32",
              "deepseek-v2 width"),
             (4, 1024, 1057, 128, 128, 192, 128, "causal", 0, 1024,
              "float32", "MLA prefill"),
             (4, 1500, 1500, 6, 6, 64, 64, "none", 0, None, "float32",
              "whisper encoder"),
             (4, 1024, 1057, 6, 6, 64, 64, "causal", 0, 1024, "float32",
              "whisper prefill"),
             (4, 1024, 1500, 6, 6, 64, 64, "none", 0, None, "float32",
              "whisper cross prefill"),
             (4, 1, 1057, 16, 8, 128, 128, "causal", 0, 1025, "float32",
              "internlm2 decode"),
             (4, 1, 1057, 128, 128, 192, 128, "causal", 0, 1025, "float32",
              "MLA decode"),
             (4, 1, 1500, 6, 6, 64, 64, "none", 0, None, "float32",
              "whisper cross"),
             (4, 1, 1057, 6, 6, 64, 64, "causal", 0, 1025, "float32",
              "whisper decode"),
             (4, 1, 1057, 48, 8, 128, 128, "causal", 0, 1025, "float32",
              "grok-1 decode"),
             (4, 1, 1057, 64, 8, 128, 128, "causal", 0, 1025, "float32",
              "qwen2-vl decode"),
             (4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None, "bfloat16",
              "hymba prefill"),
             (4, 1024, 1057, 16, 8, 128, 128, "causal", 0, 1024, "bfloat16",
              "internlm2 prefill"),
             (4, 1, 1057, 16, 8, 128, 128, "causal", 0, 1025, "bfloat16",
              "internlm2 decode"),
             (4, 1, 1057, 128, 128, 192, 128, "causal", 0, 1025, "bfloat16",
              "MLA decode"))
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 8e-3)}
# the attention backward: (B, Sq, Sk, H, KV, D, Dv, mask, window,
# kv_valid_len, dtype, tag): the training shapes of chip_smoke's phase 17
FA_BWD_SHAPES = ((4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None,
                  "bfloat16", "hymba train"),
                 (1, 1024, 1024, 16, 8, 128, 128, "causal", 0, None,
                  "bfloat16", "internlm2 train"),
                 (1, 512, 512, 16, 16, 192, 128, "causal", 0, None,
                  "bfloat16", "MLA train"),
                 (1, 1500, 1500, 6, 6, 64, 64, "none", 0, None, "bfloat16",
                  "whisper encoder train"),
                 (4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None,
                  "float32", "hymba train"),
                 (1, 1024, 1024, 16, 8, 128, 128, "causal", 0, None,
                  "float32", "internlm2 train"),
                 (1, 512, 512, 16, 16, 192, 128, "causal", 0, None,
                  "float32", "MLA train"),
                 (1, 1500, 1500, 6, 6, 64, 64, "none", 0, None, "float32",
                  "whisper encoder train"))
# the scan: (B, S, Di, Ds, h0, tag): serving (forward) and training
# (backward) shapes of Hymba and Falcon-Mamba
MS_SHAPES = ((4, 1152, 3200, 16, False, "hymba prefill"),
             (4, 1, 3200, 16, True, "hymba decode"),
             (4, 1024, 8192, 16, True, "falcon-mamba prefill"),
             (4, 1, 8192, 16, True, "falcon-mamba decode"))
MS_BWD_SHAPES = ((4, 1152, 3200, 16, False, "hymba train"),
                 (1, 512, 8192, 16, True, "falcon-mamba width"))


def emit(**row):
    print(json.dumps(row), flush=True)


def bind(kernel: str, sources):
    """Build ``sources`` and return (C entry, build log path); the scan
    backward's entry also carries ``takes_states`` (this checkout's ABI:
    the forward's chunk states and the plan of ``mamba_scan_bwd_split``)
    and ``lib``."""
    path = build_library(SOURCES[kernel][0], sources)
    lib = ctypes.CDLL(str(path))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    if kernel == "pareto_rank":
        fn = lib.pareto_rank_dominance_counts
        fn.argtypes = [ptr] * 3 + [i] * 2 + [ptr]
    elif kernel == "flash_attention":
        fn = lib.flash_attention_fwd
        fn.argtypes = [ptr] * 4 + [i] * 12 + [ptr]
    elif kernel == "flash_attention_bwd":
        fn = lib.flash_attention_bwd
        fn.argtypes = [ptr] * 10 + [i] * 12 + [ptr]
    elif kernel == "mamba_scan":
        fn = lib.mamba_selective_scan
        fn.argtypes = [ptr] * 8 + [i] * 4 + [ptr]
    else:
        fn = lib.mamba_selective_scan_bwd
        fn.takes_states = hasattr(lib, "mamba_scan_bwd_split")
        fn.argtypes = [ptr] * (16 if fn.takes_states else 15) + [i] * 4 + [
            ptr]
        if fn.takes_states:
            lib.mamba_scan_bwd_split.argtypes = [i] * 3 + [ptr]
        fn.lib = lib
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
    """Per shape: (label, launch, check, output) for one library."""
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
        cases.append((f"({n}, {k})", launch, check, out))
    return cases


def fa_cases(fn):
    from .flash_attention.ref import MASK_KINDS, attention_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for B, Sq, Sk, H, KV, D, Dv, mask, w, kvl, dtype, tag in FA_SHAPES:
        dt = getattr(torch, dtype)
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Sk, KV, Dv, generator=gen, device="cuda").to(dt)
        out = torch.empty(B, Sq, H, Dv, device="cuda", dtype=dt)
        want = attention_ref(q, k, v, mask, w, kvl).float()
        valid = Sk if kvl is None else kvl
        offset = 0 if kvl is None else kvl - Sq

        def launch(q=q, k=k, v=v, out=out, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV,
                   D=D, Dv=Dv, mask=mask, w=w, valid=valid, offset=offset,
                   code=int(dt == torch.bfloat16)):
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), code, B, Sq, Sk, H, KV, D, Dv,
                      MASK_KINDS.index(mask), w, valid, offset, stream_now())

        def check(out=out, want=want, tol=FA_TOL[dtype]):
            diff = (out.float() - want).abs()
            err = float(diff.max())
            ok = bool((diff <= tol[0] + tol[1] * want.abs()).all())
            return dict(max_abs_err=err, within_tol=ok)
        cases.append((f"{tag} {dtype} {(B, Sq, Sk, H, KV, D, Dv, mask)}",
                      launch, check, out))
    return cases


def fa_bwd_cases(fn):
    """The attention backward at the training shapes: residuals from this
    checkout's forward (the port's wrapper), checked against the plain
    backward (float32) or the tensor-core mirror (bfloat16)."""
    from .flash_attention import ops
    from .flash_attention.ref import (MASK_KINDS, flash_attention_bwd_blocked,
                                      flash_attention_bwd_tc_mirror,
                                      tc_bwd_agreement)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for B, Sq, Sk, H, KV, D, Dv, mask, w, kvl, dtype, tag in FA_BWD_SHAPES:
        dt = getattr(torch, dtype)
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
        q, k, v, dout = r(B, Sq, H, D), r(B, Sk, KV, D), r(B, Sk, KV, Dv), \
            r(B, Sq, H, Dv)
        out, lse = ops.flash_attention_fwd_lse(q, k, v, mask, w, kvl)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((B, H, Sq), device="cuda")
        if dt == torch.float32:
            want = flash_attention_bwd_blocked(q, k, v, out, lse, dout, mask,
                                               w, kvl)
        else:
            want = flash_attention_bwd_tc_mirror(q, k, v, out, lse, dout,
                                                 mask, w, kvl)
        valid = Sk if kvl is None else kvl
        offset = 0 if kvl is None else kvl - Sq

        def launch(q=q, k=k, v=v, out=out, lse=lse, dout=dout, grads=grads,
                   delta=delta, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, D=D, Dv=Dv,
                   mask=mask, w=w, valid=valid, offset=offset,
                   code=int(dt == torch.bfloat16)):
            return fn(*(x.data_ptr() for x in (q, k, v, out, lse, dout,
                                               *grads, delta)),
                      code, B, Sq, Sk, H, KV, D, Dv, MASK_KINDS.index(mask),
                      w, valid, offset, stream_now())

        def check(grads=grads, want=want, dt=dt):
            err, ok = 0.0, True
            for a, b in zip(grads, want):
                if dt == torch.bfloat16:
                    agreement = tc_bwd_agreement(a, b)
                    err = max(err, agreement["max_abs_err"])
                    ok = ok and agreement["ok"]
                    continue
                diff = (a - b).abs()
                err = max(err, float(diff.max()))
                ok = ok and bool((diff <= 3e-5 + 3e-5 * b.abs()).all())
            return dict(max_abs_err=err, within_tol=ok)
        cases.append((f"{tag} {dtype} {(B, Sq, Sk, H, KV, D, Dv, mask)}",
                      launch, check, _Joined(grads)))
    return cases


class _Joined:
    """Several output tensors compared and cloned as one."""

    def __init__(self, parts):
        self.parts = parts

    def clone(self):
        return _Joined(tuple(p.clone() for p in self.parts))

    def equal(self, other) -> bool:
        return all(torch.equal(a, b) for a, b in zip(self.parts,
                                                     other.parts))

    def max_diff(self, other) -> float:
        return max(_max_diff(a, b) for a, b in zip(self.parts, other.parts))


def _max_diff(a, b) -> float:
    """The largest elementwise |a - b| (0 for empty tensors)."""
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _scan_inputs(gen, B, S, Di, Ds, h0: bool):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
    A = -torch.exp(r(Di, Ds) * 0.3)
    return u, dl, A, r(B, S, Ds), r(B, S, Ds), r(B, Di, Ds) if h0 else None


def ms_cases(fn):
    """The scan forward at the serving shapes, against the plain scan."""
    from .mamba_scan.ref import selective_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for B, S, Di, Ds, with_h0, tag in MS_SHAPES:
        u, dl, A, Bc, Cc, h0 = _scan_inputs(gen, B, S, Di, Ds, with_h0)
        outs = (torch.empty(B, S, Di, device="cuda"),
                torch.empty(B, Di, Ds, device="cuda"))
        want = selective_scan_ref(u, dl, A, Bc, Cc, h0)

        def launch(args=(u, dl, A, Bc, Cc, h0), outs=outs, B=B, S=S, Di=Di,
                   Ds=Ds):
            return fn(*(None if x is None else x.data_ptr()
                        for x in (*args, *outs)), B, S, Di, Ds, stream_now())

        def check(outs=outs, want=want):
            err, ok = 0.0, True
            for a, b in zip(outs, want):
                diff = (a - b).abs()
                err = max(err, float(diff.max()))
                ok = ok and bool((diff <= 1e-4 + 1e-4 * b.abs()).all())
            return dict(max_abs_err=err, within_tol=ok)
        cases.append((f"{tag} {(B, S, Di, Ds)}", launch, check,
                      _Joined(outs)))
    return cases


def ms_bwd_cases(fn):
    """The scan backward at the training shapes, against the plain
    reverse-time backward; a backward that takes the forward's chunk
    states gets them from this checkout's forward."""
    from .mamba_scan import ops
    from .mamba_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for B, S, Di, Ds, with_h0, tag in MS_BWD_SHAPES:
        u, dl, A, Bc, Cc, h0 = _scan_inputs(gen, B, S, Di, Ds, with_h0)
        dy = torch.randn(B, S, Di, generator=gen, device="cuda")
        dhT = torch.randn(B, Di, Ds, generator=gen, device="cuda") \
            if with_h0 else None
        states = ops.selective_scan_fwd_states(u, dl, A, Bc, Cc, h0)[2]
        outs = (torch.empty(B, S, Di, device="cuda"),
                torch.empty(B, S, Di, device="cuda"),
                torch.empty(Di, Ds, device="cuda"),
                torch.empty(B, S, Ds, device="cuda"),
                torch.empty(B, S, Ds, device="cuda"),
                torch.empty(B, Di, Ds, device="cuda") if with_h0 else None)
        want = selective_scan_bwd_ref(u, dl, A, Bc, Cc, h0, dy, dhT)
        if fn.takes_states:
            plan = (ctypes.c_int * 6)()
            if fn.lib.mamba_scan_bwd_split(B, Di, Ds, plan) != 0:
                raise RuntimeError("mamba_scan_bwd_split failed")
            n = B * Di * Ds + B * S * plan[1] * 2 * Ds
            sixth, more = states, (plan,)
        else:           # a backward that plans itself and takes h0
            fn.lib.mamba_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
            fn.lib.mamba_scan_bwd_scratch.restype = ctypes.c_longlong
            n = fn.lib.mamba_scan_bwd_scratch(B, S, Di, Ds)
            sixth, more = h0, ()
        scratch = torch.empty(max(1, n), device="cuda")

        def launch(args=(u, dl, A, Bc, Cc, sixth, dy, dhT), outs=outs,
                   more=more, scratch=scratch, B=B, S=S, Di=Di, Ds=Ds):
            return fn(*(None if x is None else x.data_ptr()
                        for x in (*args, *outs)), *more,
                      scratch.data_ptr(), B, S, Di, Ds, stream_now())

        def check(outs=outs, want=want):
            err, ok = 0.0, True
            for a, b in zip(outs, want):
                if b is None:
                    continue
                diff = (a - b).abs()
                err = max(err, float(diff.max()))
                ok = ok and bool((diff <= 1e-4 + 1e-4 * b.abs()).all())
            return dict(max_abs_err=err, within_tol=ok)
        cases.append((f"{tag} {(B, S, Di, Ds)}", launch, check,
                      _Joined(tuple(o for o in outs if o is not None))))
    return cases


MAKE = {"pareto_rank": pareto_cases, "flash_attention": fa_cases,
        "flash_attention_bwd": fa_bwd_cases, "mamba_scan": ms_cases,
        "mamba_scan_bwd": ms_bwd_cases}


def compare(kernel: str, dirs, rounds: int):
    lib, names, optional = SOURCES[kernel]
    here = Path(__file__).resolve().parent / lib / "csrc"
    versions = {"this checkout": [here / f for f in names + optional]}
    for d in dirs:
        versions[str(d)] = [Path(d) / f for f in names + optional
                            if f in names or (Path(d) / f).is_file()]
    make = MAKE[kernel]
    cases = {}
    for label, sources in versions.items():
        t0 = time.perf_counter()
        fn, log = bind(kernel, sources)
        emit(kernel=kernel, version=label, build_s=time.perf_counter() - t0,
             ptxas=ptxas(log))
        cases[label] = make(fn)
    timed, first = {}, {}
    for label, cs in cases.items():
        for shape, launch, check, out in cs:
            rc = launch()
            torch.cuda.synchronize()
            if rc != 0:
                emit(kernel=kernel, version=label, shape=shape, refused=rc)
                continue
            verdict = check()
            ref = first.setdefault(shape, out.clone())
            joined = isinstance(out, _Joined)
            same = ref.equal(out) if joined else bool(torch.equal(out, ref))
            diff = ref.max_diff(out) if joined else _max_diff(out, ref)
            emit(kernel=kernel, version=label, shape=shape,
                 bitwise_equal_to_first=same, max_abs_diff_to_first=diff,
                 **verdict)
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


# run in a fresh process against one source tree's ``repro_torch``: uses
# only what every version of the port has (the evaluator and the sampler)
EVALUATE_SNIPPET = r"""
import json, torch
from repro_torch.core import presets
from repro_torch.core.encoding import DesignSpace, random_design
from repro_torch.core.evaluate import SystemSpec, make_batch_evaluator
spec = SystemSpec.build(presets.transformer_block(), ch_max=4)
pop = random_design(7, DesignSpace(spec), n=64, device="cuda")
ev = make_batch_evaluator(spec, device="cuda")
first = ev(pop)
differ = sum(any(not torch.equal(first[k], m[k]) for k in first)
             for m in [ev(pop) for _ in range(20)])
for _ in range(3):
    ev(pop)
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
    enable_timing=True)
torch.cuda.synchronize()
a.record()
for _ in range(20):
    ev(pop)
b.record()
torch.cuda.synchronize()
print(json.dumps(dict(ms=a.elapsed_time(b) / 20, differing_of_20=differ)))
"""


def evaluate(roots, rounds: int):
    here = Path(__file__).resolve().parents[3]
    trees = [here] + [Path(r).resolve() for r in roots]
    readings = {str(t): [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            env = dict(os.environ, PYTHONPATH=str(tree / "src"))
            out = subprocess.run([sys.executable, "-c", EVALUATE_SNIPPET],
                                 env=env, capture_output=True, text=True,
                                 check=True, cwd=tree)
            row = json.loads(out.stdout.strip().splitlines()[-1])
            readings[str(tree)].append(row)
            emit(evaluate=str(tree), round=r, **row)
    for tree, rows in readings.items():
        ms = [x["ms"] for x in rows]
        emit(evaluate=tree, ms_per_evaluation=ms, min_ms=min(ms),
             max_ms=max(ms),
             differing_of_20=[x["differing_of_20"] for x in rows])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=KERNELS + ("wrapper", "evaluate"))
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab: needs a CUDA card")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    if args.what == "wrapper":
        wrapper(args.rounds)
    elif args.what == "evaluate":
        evaluate(args.dirs, args.rounds)
    else:
        compare(args.what, args.dirs, args.rounds)


if __name__ == "__main__":
    main()
