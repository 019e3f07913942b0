"""Where K4's time goes on the card: the scan with parts switched off.

    python -m repro_torch.kernels.ssm_scan.probe         # needs an H100
    python -m repro_torch.kernels.ssm_scan.probe rates   # mma.sync and FMA rates

Each variant is ``csrc/gla_scan.cu`` with a few lines replaced (the
anchors in :data:`PATCHES`; the probe fails when the source no longer
holds one), built for chunk 64 only with the same nvcc flags into
``src/repro_torch/_build/`` and timed at the two widths of
``chip_smoke.py``'s K4 phase (zamba2-2.7b's Mamba2 layer, k and q bf16
and shared by the heads, and xlstm-1.3b's mLSTM layer, f32; B = 8,
S = 2,048), L2 flushed before each call. A variant with a part switched
off computes wrong outputs on purpose: it measures what the rest costs.
"plain tf32" keeps every product but takes one TF32 pass (hi times hi)
in place of 3xTF32; its error against the plain sequential version is
printed beside the base's, as a share of max|plain| (the gate is 1e-4).
"no tile copies" drops the q and k tile loads after the first (the
products read stale tiles). "sections" keeps the arithmetic and adds
``clock64`` counters around the parts of the walk's step, summed over
every warp; the counters themselves cost a little. ``rates`` times
independent chains of ``mma.sync`` m16n8k8 TF32, m16n8k16 bf16 and f32
FMA on every SM: the rates the design is held to.

Prints one line a variant and width, then the card's name and power
limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import _probe
from repro_torch.kernels.ssm_scan import ops, ref

SHAPES = (  # label, (B, S, H, dk, dv), dtypes of a, k, v, q, k/q shared by the heads
    ("zamba2-2.7b", (8, 2048, 80, 64, 64), ("float32", "bfloat16", "float32", "bfloat16"), True),
    ("xlstm-1.3b", (8, 2048, 4, 1024, 1025), ("float32",) * 4, False),
)
CHUNK = 64
#: batch.heads of each width held against the plain version (it is slow).
CHECKED = {"zamba2-2.7b": 48, "xlstm-1.3b": 2}

# Every variant: chunk 64 only, so a build takes a third of the time.
_CHUNK64 = (("    case 16: return exact ? launch<16, true>(p, B, s) : launch<16, false>(p, B, s);\n"
             "    case 32: return exact ? launch<32, true>(p, B, s) : launch<32, false>(p, B, s);\n",
             ""),)
_NO_WALK = (("  if (rc != 0) return rc;\n  return with_tiling(p.dk",
             "  return rc;\n  return with_tiling(p.dk"),)
_NO_SCORES = (("  const int rc = launch_scores<C, EXACT>(p, B, stream);",
               "  const int rc = 0;"),)
_NO_PRODUCTS = (('{\n  asm("mma.sync.aligned', '{\n  return;\n  asm("mma.sync.aligned'),)
_NO_INTRA = (("            mma3(yr[j], vah, val, ph, pl);\n", ""),)
_NO_READ = (("              mma2(yr[j + m], ah, al, bb);\n", ""),
            ("            mma3(yr[j], ah, al, bh, bl);\n", ""))
_NO_CARRY = (("              mma2(acc[g + m], vdh[k], vdl[k], bb);\n", ""),
             ("              mma2(acc[g], vdh[k], vdl[k], bb);\n", ""),
             ("              mma3(acc[g], vdh[k], vdl[k], bh, bl);\n", ""))
_PLAIN_TF32 = (("  mma(d, al, bh);\n  mma(d, ah, bl);\n  mma(d, ah, bh);\n", "  mma(d, ah, bh);\n"),
               ("  mma(d, al, b);\n  mma(d, ah, b);\n", "  mma(d, ah, b);\n"))

_NO_TILE_COPIES = (("    if (f + ahead < total) issue_tile(f + ahead);\n", ""),
                   ("    if (p.tma_qk) mbar_wait(bars + f % L.slots, (f / L.slots) & 1);\n", ""))
#: Counted parts of the walk's step, in order.
SECTIONS = ("wait and barrier", "issue copies", "chunk start (P, v d)",
            "read and carry", "chunk end (intra, sum, store, la)")
_CLOCK = "{ const unsigned long long n_ = clock64(); pa_[{i}] += n_ - pt_; pt_ = n_; }"
_SECTIONS = (
    ("namespace {\n", "__device__ unsigned long long k4_sections[8];\nnamespace {\n"),
    ("  float decay = 0.f;\n",
     "  float decay = 0.f;\n  unsigned long long pt_ = clock64(), pa_[8] = {};\n"),
    ("    __syncthreads();  // this step's tiles are in; every warp is done with the last step's\n",
     "    __syncthreads();\n    @0\n"),
    ("    if (i == 0 && c + 1 < p.n_chunks) issue_chunk(c + 1);\n    cp_async_commit();\n",
     "    if (i == 0 && c + 1 < p.n_chunks) issue_chunk(c + 1);\n    cp_async_commit();\n"
     "    @1\n"),
    ("      __syncthreads();  // P is in\n    }\n",
     "      __syncthreads();  // P is in\n    }\n    @2\n"),
    ("        hrow[g * MT * 32] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);\n    }\n",
     "        hrow[g * MT * 32] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);\n    }\n"
     "    @3\n"),
    ("      if (warp == 0 && c + 1 < p.n_chunks) write_la(c + 1);\n    }\n  }\n}\n",
     "      if (warp == 0 && c + 1 < p.n_chunks) write_la(c + 1);\n    }\n    @4\n"
     "    pa_[7] += 1;\n  }\n  if (lane == 0)\n"
     "    for (int s_ = 0; s_ < 8; ++s_) atomicAdd(&k4_sections[s_], pa_[s_]);\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\nint k4_sections_read(unsigned long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, k4_sections, sizeof(k4_sections));\n}\n"
     "int k4_sections_reset() {\n  unsigned long long z[8] = {};\n"
     "  return (int)cudaMemcpyToSymbol(k4_sections, z, sizeof(z));\n}\n"),
)

#: Variant name -> (anchor, replacement) pairs applied to the source.
PATCHES = {
    "base": (),
    "scores only": _NO_WALK,
    "walk only": _NO_SCORES,
    "loads only": _NO_PRODUCTS,
    "no intra": _NO_INTRA,
    "no read": _NO_READ,
    "no carry": _NO_CARRY,
    "plain tf32": _PLAIN_TF32,
    "no tile copies": _NO_TILE_COPIES,
    "sections": _SECTIONS,
}


def variant_source(name: str) -> str:
    return _probe.variant_source(ops.SOURCE, name, _CHUNK64 + PATCHES[name], _CLOCK)


def build(name: str) -> ctypes.CDLL:
    """Compile the variant's source beside the kernel libraries."""
    return ops.bind(_probe.build("k4_probe_" + name.replace(" ", "_"), variant_source(name)))


def flushed_ms(fn):
    return _probe.flushed_ms(fn, n=20, warmup=2)


def inputs(shape, dtypes, shared, gen):
    b, s, h, dk, dv = shape
    kq_heads = 1 if shared else h
    a = 0.6 + 0.4 * torch.rand(b, s, h, device="cuda", generator=gen)
    k = torch.randn(b, s, kq_heads, dk, device="cuda", generator=gen) * dk ** -0.5
    q = torch.randn(b, s, kq_heads, dk, device="cuda", generator=gen) * dk ** -0.5
    v = torch.randn(b, s, h, dv, device="cuda", generator=gen)
    a, k, v, q = (x.to(getattr(torch, d)) for x, d in zip((a, k, v, q), dtypes))
    return a, k.expand(b, s, h, dk), v, q.expand(b, s, h, dk)


# Peak instruction rates on this card: independent chains of one
# instruction, 8 warps on every SM, timed with CUDA events.
_RATES_SRC = r"""
#include <stdint.h>
template <int OP>
__global__ void __launch_bounds__(256) rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u + threadIdx.x, b[1] = b[0] + 7;
  float d[8][4] = {};
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (OP == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else if (OP == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
#pragma unroll
        for (int u = 0; u < 4; ++u) x[k] = fmaf(x[k], 0.999f, d[k][u] + 1e-7f);
    }
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3] + x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rate_run(int op, float* out, int blocks, int iters) {
  if (op == 0) rate<0><<<blocks, 256>>>(out, iters);
  else if (op == 1) rate<1><<<blocks, 256>>>(out, iters);
  else rate<2><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def rates():
    """Print the card's measured rate of mma.sync m16n8k8 TF32, m16n8k16
    bf16 and f32 FMA, each as TFLOP/s."""
    lib = _probe.build("k4_probe_rates", _RATES_SRC)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    iters = 4096
    # flops a warp-instruction: m16n8k8 2 * 16 * 8 * 8, m16n8k16 twice that;
    # the FMA loop runs 4 FMAs (8 flops) a lane per step.
    for op, label, flops in ((0, "mma.sync m16n8k8 tf32", 2048), (1, "mma.sync m16n8k16 bf16", 4096),
                             (2, "f32 fma", 8 * 32)):
        call = lambda: lib.rate_run(op, ctypes.c_void_p(out.data_ptr()), blocks, iters)
        call()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        total = blocks * 8 * iters * 8 * flops
        print(f"probe rate {label}: {total / ms / 1e9:.1f} TFLOP/s "
              f"({blocks} blocks of 8 warps, {ms:.3f} ms)", flush=True)


def main(names=tuple(PATCHES)):
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, shape, dtypes, shared in SHAPES:
        x = inputs(shape, dtypes, shared, gen)
        b, s, h, dk, dv = shape
        y = torch.empty(b, s, h, dv, device="cuda")
        fold = lambda t: t.transpose(1, 2).reshape((b * h, s) + t.shape[3:])
        n = CHECKED[label]
        want = ref.gla_scan_ref(*(fold(t)[:n] for t in x))
        top = want.abs().max().item()
        for name, lib in libs.items():
            ms = flushed_ms(lambda: ops.launch(lib, *x, y, CHUNK))
            line = f"probe {label} {name:<12} {ms:.4f} ms"
            if name in ("base", "plain tf32"):
                ops.launch(lib, *x, y, CHUNK)
                err = (fold(y)[:n] - want).abs().max().item()
                line += f"; max abs err {err / top:.3g} of max|plain|"
            if name == "sections":
                lib.k4_sections_reset()
                ops.launch(lib, *x, y, CHUNK)
                torch.cuda.synchronize()
                counts = (ctypes.c_ulonglong * 8)()
                lib.k4_sections_read(counts)
                steps, total = counts[7], sum(counts[:5])
                line += (f"; {steps} warp steps, {total / steps:.0f} clocks a step: "
                         + ", ".join(f"{sec} {counts[i] / steps:.0f} "
                                     f"({100 * counts[i] / total:.0f} %)"
                                     for i, sec in enumerate(SECTIONS)))
            print(line, flush=True)
        del x, y, want
    print(_probe.card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["rates"]:
        sys.exit(rates())
    sys.exit(main(tuple(sys.argv[1:]) or tuple(PATCHES)))
