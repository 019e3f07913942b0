"""Where K1's and K2's time goes on the card, and the kernel against the
one of another checkout.

    python -m repro_torch.kernels.aggregate.probe               # needs an H100
    python -m repro_torch.kernels.aggregate.probe trees OLD      # OLD: a checkout

Each variant is ``csrc/aggregate.cu`` with a few lines replaced (the
anchors in :data:`PATCHES`; the probe fails when the source no longer
holds one) and the launch geometry of :data:`GEOMETRY`, built with the
same nvcc flags into ``src/repro_torch/_build/`` (one build a distinct
source) and timed at the Fig-1 shape (N = 40, P = 316,554, f32), dense
and with 4 of the 40 rows masked, beside ``torch.mv`` / ``torch.addmv``.
A variant with a part switched off computes wrong outputs on purpose: it
measures what the rest costs. Each time is given three ways: the L2
flushed by a read pass before each call (the yardstick ``chip_smoke.py``
uses), flushed by zeroing the buffer (the yardstick before it, which
leaves dirty lines), and back to back, enqueued behind a spin of the
card so that the wrappers' host time does not show. The bound counts the
bytes the call must move: the rows it reads (36 when 4 are masked), w,
the mask, params, the output.

``trees OLD`` imports the aggregate wrappers of the checkout OLD beside
this checkout's (through their public signatures, so it works whatever
the C entry points of either take) and runs old, new, new, old on the
same inputs, at the Fig-1 shape and at P = 2,049: their K1, K2 and delta
outputs must be the same bits (f32 and bf16 g, dense and masked), and
each is timed the three ways, with the library call in the same turns.

First come the "fixed" lines: what a call costs with next to no work (a
one-element add, ``torch.mv`` and each variant at P = 2,049), the
geometry's least span tried at P = 2,049 and 20,000, and the host time
of a wrapper call. The read-flushed time of a variant is the mean of
ROUNDS turns taken in rotation with the other variants and the library
call (the range beside it), so a drift of the card's clock falls on all
of them alike. Prints one line a variant (or tree) and case, then the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _probe
from repro_torch.kernels.aggregate import ops

N, P, LR = 40, 316_554, 0.05
MASKED = (3, 13, 22, 31)  # the clients the Fig-1 phase of chip_smoke.py masks
HBM = 3.35e12             # H100 SXM, bytes/s
CALLS, WARMUP, ROUNDS = 40, 3, 3
SMALL_P, MID_P = 2_049, 20_000
SPIN_CYCLES = 20_000_000  # ~10 ms of the card: longer than 40 calls' host time

_LOADS_ONLY = ("      for (int r = 0; r < rows; ++r) {\n        const int j = j0 + r;",
               "      for (int r = 0; r < 0; ++r) {\n        const int j = j0 + r;")
_NO_COPIES = (("                                          uint64_t* bar) {\n  asm volatile(",
               "                                          uint64_t* bar) {\n  return;\n  asm volatile("),
              ("mbar_arrive_expect_tx(full + s, bytes);", "mbar_arrive_expect_tx(full + s, 0);"))
_NO_SMEM_READS = ("const float x = sel ? to_f32(row[col[i]]) : 0.f;",
                  "const float x = sel ? (float)i : 0.f;")
_ROWS_ONE_BY_ONE = ("#pragma unroll 4\n      for (int r = 0; r < rows; ++r) {",
                    "#pragma unroll 1\n      for (int r = 0; r < rows; ++r) {")
_READ_MASKED = ("const unsigned copy = __ballot_sync(~0u, ahead.m > 0.f);",
                "const unsigned copy = ~0u;")
# The columns past the chunk read at their own index, past the row (into
# the next row, or a pad after the ring): the form before the clamp.
_UNCLAMPED = (("    col[i] = min(t + i * kConsumers, cw - 1);",
               "    col[i] = t + i * kConsumers;"),
              ("  return kBarBytes + geo.stages * geo.rows * geo.pitch;",
               "  return kBarBytes + geo.stages * geo.rows * geo.pitch +\n"
               "         (kConsumers * kCols - geo.chunk) * 4;"))
# Every warp sums kCols columns a thread in every chunk, whatever the
# chunk's width: the form before the count was chosen a chunk.
_ALL_COLUMNS = ("    const int cols = cw > t0 ? (cw - t0 + kConsumers - 1) / kConsumers : 0;",
                "    const int cols = kCols;")

#: Variant name -> (anchor, replacement) pairs applied to the source.
PATCHES = {
    "base": (),
    "loads only": (_LOADS_ONLY,),
    "no copies": (_LOADS_ONLY,) + _NO_COPIES,
    "no smem reads": (_NO_SMEM_READS,),
    "masked rows read": (_READ_MASKED,),
    "unclamped cols": _UNCLAMPED,
    "all columns": (_ALL_COLUMNS,),
    "rows one by one": (_ROWS_ONE_BY_ONE,),
    "1 row a stage": (),
    "2 rows a stage": (),
    "4 rows a stage": (),
    "2 blocks a SM": (),
}
#: Variant name -> (blocks a SM, stages, rows a stage); None keeps the
#: geometry's own. The pitch stays the geometry's.
GEOMETRY = {"1 row a stage": (1, 16, 1), "2 rows a stage": (1, 10, 2),
            "4 rows a stage": (1, 5, 4), "2 blocks a SM": (2, 2, None)}
#: The fewest 16-byte units a block owns, tried at the small sizes
#: (``ops.MIN_UNITS`` is the geometry's; 1 gives one block a SM there).
MIN_UNITS_TRIED = (1, 16, 64, 256)


def variant_source(name: str) -> str:
    return _probe.variant_source(ops.SOURCE, name, PATCHES[name])


def build(name: str) -> ctypes.CDLL:
    """Compile the variant's source beside the kernel libraries."""
    return ops.bind(_probe.build("k12_probe_" + name.replace(" ", "_"),
                                 variant_source(name)))


def build_all(names) -> dict:
    """Each variant's library: one build for each distinct source, all
    compiled at once."""
    first = {}
    for name in names:
        first.setdefault(PATCHES[name], name)
    with ThreadPoolExecutor(len(first)) as pool:
        built = dict(zip(first, pool.map(build, first.values())))
    return {name: built[PATCHES[name]] for name in names}


def variant_geometry(name: str, p: int = P, esize: int = 4,
                     min_units: int = ops.MIN_UNITS) -> ops.Geometry:
    per_sm, stages, rows = GEOMETRY.get(name, (1, None, None))
    geo = ops.geometry(p, esize, per_sm * ops.sm_count(torch.cuda.current_device()),
                       min_units=min_units)
    return dataclasses.replace(geo, stages=stages or geo.stages, rows=rows or geo.rows)


def inputs(seed: int = 0, p: int = P):
    """The Fig-1 shape's operands (or ``p`` columns): g (f32), w at the
    trainer's scale, a mask with 4 of 40 rows out, params and eta."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(N, p, device="cuda", generator=gen)
    w = torch.rand(N, device="cuda", generator=gen) * (2.0 / N)
    mask = torch.ones(N, device="cuda")
    mask[list(MASKED)] = 0.0
    params = torch.randn(p, device="cuda", generator=gen)
    return g, w, mask, params, torch.tensor(LR, device="cuda")


def spin_up(seconds: float = 0.5):
    """Keep the card busy for a while, so its clocks are up before the
    first timing."""
    x = torch.zeros(64 * 2 ** 20, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    while True:
        for _ in range(100):
            torch.sum(x)
        end.record()
        end.synchronize()
        if start.elapsed_time(end) > seconds * 1e3:
            return


def bound_ms(form: str, masked: bool, p: int = P) -> float:
    rows = N - len(MASKED) if masked else N
    nbytes = 4 * (rows * p + N + (N if masked else 0) + p)
    if form == "k2":
        nbytes += 4 * (p + 1)
    return nbytes / HBM * 1e3


def queued_ms(fn, n: int = CALLS, warmup: int = WARMUP) -> float:
    """Mean ms a call over ``n`` calls run back to back on the card,
    enqueued while it spins, so the time is the card's alone even where
    a call's host time is longer than its kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda._sleep(SPIN_CYCLES)
    spun.record()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    if spun.query():
        raise RuntimeError("the spin ended before the calls were enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def times(fn):
    """(read flush, zero flush, back to back) ms."""
    return (_probe.flushed_ms(fn, CALLS, WARMUP),
            _probe.flushed_ms(fn, CALLS, WARMUP, write=True),
            queued_ms(fn))


def us(t) -> str:
    return " | ".join(f"{x * 1e3:.2f}" for x in t)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def new_calls(lib, geo, g, w, mask, params, eta, out):
    """K1 and K2 through this checkout's C entry points, into ``out``."""
    c_geo = ctypes.byref(ops.c_geometry(geo))
    n, p = g.shape
    m = lambda masked: mask.data_ptr() if masked else None
    k1 = lambda masked: lib.masked_scaled_aggregate(
        g.data_ptr(), 0, w.data_ptr(), m(masked), out.data_ptr(), 0, n, p, c_geo,
        _stream())
    k2 = lambda masked: lib.masked_scaled_aggregate_update(
        g.data_ptr(), 0, w.data_ptr(), m(masked), eta.data_ptr(), params.data_ptr(),
        0, out.data_ptr(), 0, n, p, c_geo, _stream())
    return {"k1": k1, "k2": k2}


def fixed_costs(g, w, libs):
    """What a call costs with next to no work, under the same three
    timings: a one-element add, and ``torch.mv`` and each variant's K1 at
    P = 2,049 (0.3 MB); the base at P = 2,049 and 20,000 for each least
    span of :data:`MIN_UNITS_TRIED`; and the host time a K1 wrapper call
    takes to enqueue at the Fig-1 shape (what bounds the wrapper's
    back-to-back figure when it exceeds the kernel's time)."""
    tiny = torch.zeros(1, device="cuda")
    sg, sw, smask, sparams, seta = inputs(p=SMALL_P)
    sout = torch.empty(SMALL_P, device="cuda")
    cases = {"one-element add": lambda: tiny.add_(1),
             "torch.mv": lambda: torch.mv(sg.t(), sw)}
    for name, lib in libs.items():
        geo = variant_geometry(name, SMALL_P)
        cases[f"K1 {name}"] = lambda call=new_calls(lib, geo, sg, sw, smask, sparams, seta,
                                                     sout)["k1"]: call(False)
    for label, fn in cases.items():
        print(f"probe fixed P={SMALL_P} {label:<24} {us(times(fn))} us "
              f"(read flush | zero flush | back to back)", flush=True)
    for p in (SMALL_P, MID_P):
        mg, mw, mmask, mparams, meta = inputs(p=p)
        mout = torch.empty(p, device="cuda")
        fns = {"torch.mv": lambda: torch.mv(mg.t(), mw)}
        for least in MIN_UNITS_TRIED:
            geo = variant_geometry("base", p, min_units=least)
            call = new_calls(libs["base"], geo, mg, mw, mmask, mparams, meta, mout)["k1"]
            fns[f"{least} units ({geo.blocks} blocks)"] = lambda call=call: call(False)
        for label, fn in fns.items():
            print(f"probe least span P={p} {label:<22} {us(times(fn))} us "
                  f"(read flush | zero flush | back to back; the geometry's "
                  f"{ops.MIN_UNITS})", flush=True)
    ops.masked_scaled_aggregate(g, w)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(200):
        ops.masked_scaled_aggregate(g, w)
    host = (time.perf_counter() - start) / 200
    torch.cuda.synchronize()
    print(f"probe fixed host time a K1 wrapper call at the Fig-1 shape "
          f"{host * 1e6:.2f} us (enqueue only)", flush=True)


def main(names=tuple(PATCHES)):
    """Each case (K1 or K2, dense or masked): the library call and every
    variant timed read-flushed in ROUNDS turns, then once zero-flushed
    and once back to back; the line gives the turns' mean and range."""
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(names)
    g, w, mask, params, eta = inputs()
    out = torch.empty(P, device="cuda")
    gt, wm = g.t(), w * mask
    spin_up()
    fixed_costs(g, w, libs)
    for form in ("k1", "k2"):
        for masked in (False, True):
            want = (ops.masked_scaled_aggregate(g, w, mask=mask if masked else None)
                    if form == "k1" else ops.masked_scaled_aggregate_update(
                        g, w, eta, params, mask if masked else None))
            fns, notes = {}, {}
            fns["library"] = ((lambda: torch.mv(gt, wm if masked else w)) if form == "k1"
                              else (lambda: torch.addmv(params, gt, wm if masked else w,
                                                        alpha=-LR)))
            notes["library"] = (f"{'torch.mv' if form == 'k1' else 'torch.addmv'}, "
                                f"reads every row")
            if not masked:
                fns["read of g"] = lambda: torch.sum(g)
                notes["read of g"] = "torch.sum(g): g read once, no output"
            m = mask if masked else None
            fns["wrapper"] = ((lambda: ops.masked_scaled_aggregate(g, w, mask=m)) if form == "k1"
                              else (lambda: ops.masked_scaled_aggregate_update(
                                  g, w, eta, params, m)))
            notes["wrapper"] = "the base kernel through its public wrapper"
            for name, lib in libs.items():
                geo = variant_geometry(name)
                call = new_calls(lib, geo, g, w, mask, params, eta, out)[form]
                rc = call(masked)
                if rc:
                    raise RuntimeError(f"probe variant {name!r}: launch returned {rc}")
                torch.cuda.synchronize()
                fns[name] = lambda call=call: call(masked)
                notes[name] = (f"{'same bits as the kernel' if torch.equal(out, want) else 'other bits'}"
                               f"; {geo.blocks} blocks, span {geo.span}, {geo.rows} rows x "
                               f"{geo.stages} stages, {geo.stages * geo.rows * geo.pitch // 1024} "
                               f"KB a block")
            turns = {name: [] for name in fns}
            for _ in range(ROUNDS):
                for name, fn in fns.items():
                    turns[name].append(_probe.flushed_ms(fn, CALLS, WARMUP))
            label = "dense" if not masked else f"{N - len(MASKED)} of {N} rows"
            bound = bound_ms(form, masked)
            for name, fn in fns.items():
                t = turns[name]
                mean = sum(t) / len(t)
                zero = _probe.flushed_ms(fn, CALLS, WARMUP, write=True)
                print(f"probe {form} {label:<13} {name:<16} {mean * 1e3:.2f} "
                      f"({min(t) * 1e3:.2f}-{max(t) * 1e3:.2f}) | {zero * 1e3:.2f} | "
                      f"{queued_ms(fn) * 1e3:.2f} us, {100 * bound / mean:.1f} % of the "
                      f"{bound * 1e3:.2f} us bound; {notes[name]}", flush=True)
    print(_probe.card_line())
    return 0


def other_tree(root: str):
    """The aggregate wrappers (``ops``) of the checkout ``root``, imported
    beside this checkout's: its ``repro_torch`` modules are imported
    afresh from ``root/src`` and this checkout's put back after."""
    mine = lambda: [k for k in sys.modules if k.split(".")[0] == "repro_torch"]
    own = {k: sys.modules.pop(k) for k in mine()}
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    try:
        return importlib.import_module("repro_torch.kernels.aggregate.ops")
    finally:
        sys.path.pop(0)
        for k in mine():
            del sys.modules[k]
        sys.modules.update(own)


def trees(root: str) -> int:
    """Old against new on the same inputs through their public wrappers:
    bits, then times in the turns old, new, library, new, old."""
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    wrappers = {"old": other_tree(root), "new": ops}
    spin_up()
    for p in (P, SMALL_P):
        g, w, mask, params, eta = inputs(p=p)

        def call(which, form, gg, masked):
            mod, m = wrappers[which], mask if masked else None
            if form == "k1":
                return mod.masked_scaled_aggregate(gg, w, mask=m)
            return mod.masked_scaled_aggregate_update(
                gg, w, eta, params if form == "k2" else None, m)

        for gg in (g, g.to(torch.bfloat16)):
            for masked in (False, True):
                for form in ("k1", "k2", "delta"):
                    a, b = call("old", form, gg, masked), call("new", form, gg, masked)
                    same = torch.equal(a, b)
                    print(f"trees bits P={p} {form:<5} g {str(gg.dtype)[6:]:<8} "
                          f"{'masked' if masked else 'dense':<6}: "
                          f"{'same bits' if same else 'DIFFERENT'} "
                          f"(max |old| {a.abs().max().item():.4g})", flush=True)
                    if not same:
                        raise AssertionError(f"{form}: old and new kernels differ")
        gt, wm = g.t(), w * mask
        for form in ("k1", "k2"):
            for masked in (False, True):
                wv = wm if masked else w
                lib_fn = ((lambda: torch.mv(gt, wv)) if form == "k1" else
                          (lambda: torch.addmv(params, gt, wv, alpha=-LR)))
                turns = []
                for which in ("old", "new", "library", "new", "old"):
                    fn = lib_fn if which == "library" else (
                        lambda which=which: call(which, form, g, masked))
                    turns.append((which, times(fn)))
                label = "dense" if not masked else f"{N - len(MASKED)} of {N} rows"
                print(f"trees time P={p} {form} {label:<13} (read flush | zero flush | back "
                      f"to back, us; bound {bound_ms(form, masked, p) * 1e3:.2f}): "
                      + "; ".join(f"{which} {us(t)}" for which, t in turns), flush=True)
    print(_probe.card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["trees"]:
        sys.exit(trees(sys.argv[2]))
    sys.exit(main(tuple(sys.argv[1:]) or tuple(PATCHES)))
