"""Where K3's time goes on the card: the bf16 kernel with parts switched off.

    python -m repro_torch.kernels.flash_attention.probe     # needs an H100

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced
(the anchors in :data:`PATCHES`; the probe fails when the source no
longer holds one), built with the same nvcc flags into
``src/repro_torch/_build/`` and timed at stablelm-1.6b's prefill shape
and minitron-4b's attention shape (B = 8, S = T = 2,048, causal), L2
flushed before each launch, beside ``F.scaled_dot_product_attention``.
A variant with a part switched off computes wrong outputs on purpose: it
measures what the rest costs. ``sections`` keeps the arithmetic and adds
``clock64`` counters around the parts of the steady-state turn (key
tiles after the first of a work tile), summed over every consumer warp;
the counters themselves cost a little.

Prints one line a variant and shape, then the card's name and power
limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import _probe
from repro_torch.kernels.flash_attention import ops

SHAPES = (  # label, (B, H, Hkv, S, Dh)
    ("prefill shape", (8, 32, 32, 2048, 64)),
    ("minitron-4b", (8, 24, 8, 2048, 128)),
)

_TURNS = ('asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "n"(128 * kConsumers) : "memory");',
          'asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "n"(128 * kConsumers) : "memory");')
_SOFTMAX = ("float& alpha0, float& alpha1) {\n    if (masked) {",
            "float& alpha0, float& alpha1) {\n"
            "    alpha0 = alpha1 = 1.f; l[0] += sc[0]; l[1] += sc[2]; return;\n"
            "    if (masked) {")
_PRODUCTS = (("int accumulate) {\n  asm volatile(", "int accumulate) {\n  return;\n  asm volatile("),
             ("uint64_t b) {\n  if constexpr (D == 64)", "uint64_t b) {\n  return;\n  if constexpr (D == 64)"))
_LOADS = (("int col, int head, int row, int batch) {\n  asm volatile(",
           "int col, int head, int row, int batch) {\n  return;\n  asm volatile("),
          ("void mbar_expect_tx(uint32_t bar, uint32_t bytes) {\n",
           "void mbar_expect_tx(uint32_t bar, uint32_t bytes) {\n  bytes = 0;\n"))

#: Counted parts of the steady-state turn, in order.
SECTIONS = ("wait K/V", "wait turn", "issue", "wait S", "softmax", "wait P V",
            "rescale, pack, release")
_CLOCK = ("{ const unsigned long long n_ = clock64(); pa_[{i}] += n_ - pt_; "
          "pt_ = n_; }")
_SECTIONS = (
    ("namespace {\n", "__device__ unsigned long long fa_sections[8];\nnamespace {\n"),
    ("    int ring = 0, used = 0;\n\n    for (int w = blockIdx.x;",
     "    int ring = 0, used = 0;\n    unsigned long long pt_ = 0, pa_[8] = {};\n\n"
     "    for (int w = blockIdx.x;"),
    ("          mbar_wait(bars, (r / P::kStages) & 1);\n",
     "          pt_ = clock64();\n          mbar_wait(bars, (r / P::kStages) & 1);\n"),
    ("          turn_wait(my_turn);\n          pin_all(sc);\n          pin_all(acc);",
     "          @0\n          turn_wait(my_turn);\n          @1\n          pin_all(sc);\n"
     "          pin_all(acc);"),
    ("          turn_pass(their_turn);\n          wgmma_wait<1>();",
     "          turn_pass(their_turn);\n          @2\n          wgmma_wait<1>();"),
    ("          pin_all(sc);\n          mbar_arrive_if(bars + 8, lead);  // K slot free\n"
     "          mbar_arrive_if(q_empty, lead && it == n - 1);",
     "          @3\n          pin_all(sc);\n          mbar_arrive_if(bars + 8, lead);\n"
     "          mbar_arrive_if(q_empty, lead && it == n - 1);"),
    ("                  alpha1);\n          wgmma_wait<0>();",
     "                  alpha1);\n          @4\n          wgmma_wait<0>();\n          @5"),
    ("          pack_p(pf, sc);\n        }\n",
     "          pack_p(pf, sc);\n          @6\n          pa_[7] += 1;\n        }\n"),
    ("acc[4 * j + 3] * r1);\n      }\n    }\n  }\n}\n",
     "acc[4 * j + 3] * r1);\n      }\n    }\n    if (lane == 0)\n"
     "      for (int i = 0; i < 8; ++i) atomicAdd(&fa_sections[i], pa_[i]);\n  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\nint fa_sections_read(unsigned long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, fa_sections, sizeof(fa_sections));\n}\n"
     "int fa_sections_reset() {\n  unsigned long long z[8] = {};\n"
     "  return (int)cudaMemcpyToSymbol(fa_sections, z, sizeof(z));\n}\n"),
)

#: Variant name -> (anchor, replacement) pairs applied to the source.
PATCHES = {
    "base": (),
    "no turns": tuple((a, "") for a in _TURNS),
    "no softmax": (_SOFTMAX,),
    "no products": _PRODUCTS,
    "products only": (_SOFTMAX,) + _LOADS,
    "softmax only": _PRODUCTS + _LOADS,
    "loads only": (_SOFTMAX,) + _PRODUCTS,
    "sections": _SECTIONS,
}


def variant_source(name: str) -> str:
    return _probe.variant_source(ops.SOURCE, name, PATCHES[name], _CLOCK)


def build(name: str) -> ctypes.CDLL:
    """Compile the variant's source beside the kernel libraries."""
    handle = _probe.build("k3_probe_" + name.replace(" ", "_"), variant_source(name))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.flash_attention.argtypes = [ptr] * 4 + [i32] * 9 + [f32, ptr]
    return handle


def flushed_ms(fn):
    return _probe.flushed_ms(fn, n=30, warmup=3)


def main(names=tuple(PATCHES)):
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, h, hkv, s, dh) in SHAPES:
        q = torch.randn(b, s, h, dh, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, s, hkv, dh, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, s, hkv, dh, device="cuda", generator=gen).bfloat16()
        out = torch.empty_like(q)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = flushed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=hkv != h))
        print(f"probe {label} B,H,Hkv,S,Dh={(b, h, hkv, s, dh)}: "
              f"F.scaled_dot_product_attention {sdpa:.4f} ms")
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h,
                    hkv, s, s, dh, 1, 0, dh ** -0.5, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"probe variant {name!r}: launch returned {rc}")
            ms = flushed_ms(call)
            line = f"probe {label} {name:<14} {ms:.4f} ms ({ms / sdpa:.2f} x SDPA)"
            if name == "sections":
                lib.fa_sections_reset()
                call()
                torch.cuda.synchronize()
                counts = (ctypes.c_ulonglong * 8)()
                lib.fa_sections_read(counts)
                turns, total = counts[7], sum(counts[:7])
                line += (f"; {turns} warp turns, {total / turns:.0f} clocks a turn: "
                         + ", ".join(f"{sec} {counts[i] / turns:.0f} "
                                     f"({100 * counts[i] / total:.0f} %)"
                                     for i, sec in enumerate(SECTIONS)))
            print(line, flush=True)
    print(_probe.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(tuple(sys.argv[1:]) or tuple(PATCHES)))
