#!/usr/bin/env python3
"""Probe variants of the Hopper sqdist kernel on one NVIDIA card.

    python3 probe_sqdist.py [--variants base,chunk16,...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is ``tdax_torch/ops/csrc/sqdist_sm90.cu`` with a few text
substitutions (``VARIANTS``), compiled by nvcc with the port's flags into
``build/probe_sqdist/`` (all at once) and loaded with ctypes beside the
port's own kernels.  The port's split pass makes hi, lo and the norms of
chip_smoke's scale cloud ([10000, 4096] f32) once.  Every variant's error
is read twice: against the plain version (cuBLAS f32), where a variant
marked exact must stay within chip_smoke's sqdist bound and be exactly
symmetric, and against the same expansion form in f64 (the f32 inputs'
exact distances), beside sqdist.cu's and the plain version's own.  All
are then timed with CUDA events in turns (A B .. B A), beside the split
pass, sqdist.cu (the port's ``_kernel="fma"``) and torch.cdist.
Variants marked diagnostic leave a part of the work out on purpose:
their error is reported, not gated.  A variant that fails to build is
reported and left out.  Prints ptxas's lines per variant, one JSON line
of errors and times and the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "tdax_torch" / "ops" / "csrc" / "sqdist_sm90.cu"
OUT = HERE / "build" / "probe_sqdist"
ITERS = 10


def _between(start, end):
    """The text of SOURCE from ``start`` up to ``end``."""
    text = SOURCE.read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


# a chunk's products as the source issues them: the small terms, then hi.hi^T
_PRODUCTS = _between("      wgmma_fence();\n#pragma unroll\n", "      wgmma_commit();\n")
# each k8 step's hi.hi^T first, then its two small terms
_INTERLEAVED = """      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const uint64_t dah = desc_sw128(a_hi + kk * 32, 0, 1024);
        const uint64_t dal = desc_sw128(a_lo + kk * 32, 0, 1024);
        const uint64_t dbh = desc_sw128(b_hi + kk * 32, 0, 1024);
        const uint64_t dbl = desc_sw128(b_lo + kk * 32, 0, 1024);
        if (kk == 0)
          wgmma_m64n128k8_tf32_ss_first(c, dah, dbh);
        else
          wgmma_m64n128k8_tf32_ss(c, dah, dbh);
        wgmma_m64n128k8_tf32_ss(c, dah, dbl);
        wgmma_m64n128k8_tf32_ss(c, dal, dbh);
      }
"""
_ONE_PASS = """      wgmma_fence();
      (void)a_lo;
      (void)b_lo;
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const uint64_t dah = desc_sw128(a_hi + kk * 32, 0, 1024);
        const uint64_t dbh = desc_sw128(b_hi + kk * 32, 0, 1024);
        if (kk == 0)
          wgmma_m64n128k8_tf32_ss_first(c, dah, dbh);
        else
          wgmma_m64n128k8_tf32_ss(c, dah, dbh);
      }
"""
# the consumers' main loop, from the chunk's issue to the epilogue
_LOOP = _between("    // Chunk q (CHUNK of d",
                 "    // ------------------------------------------------------ epilogue")
# hi.hi^T in a fresh chunk c, the small terms in their own accumulator s
# over all of d; one chunk in flight (c, s and the total fill the
# registers that two alternating chunks take)
_SEPARATE = """    float c[64], s[64], total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = s[i] = 0.f;
    const int nq = nk * CPS;
    for (int q = 0; q < nq; ++q) {
      const int kt = q / CPS;
      if (q % CPS == 0) mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      const uint32_t st = smem_u32(base + (kt % STAGES) * STAGE_BYTES) + (q % CPS) * CHUNK * 4;
      const uint32_t a_hi = st + cw * 64 * 128, a_lo = a_hi + TILE_BYTES;
      const uint32_t b_hi = diag ? st : st + 2 * TILE_BYTES, b_lo = b_hi + TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const uint64_t dah = desc_sw128(a_hi + kk * 32, 0, 1024);
        const uint64_t dal = desc_sw128(a_lo + kk * 32, 0, 1024);
        const uint64_t dbh = desc_sw128(b_hi + kk * 32, 0, 1024);
        const uint64_t dbl = desc_sw128(b_lo + kk * 32, 0, 1024);
        if (kk == 0)
          wgmma_m64n128k8_tf32_ss_first(c, dah, dbh);
        else
          wgmma_m64n128k8_tf32_ss(c, dah, dbh);
        wgmma_m64n128k8_tf32_ss(s, dah, dbl);
        wgmma_m64n128k8_tf32_ss(s, dal, dbh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(c);
      fence_regs(s);
      if (q % CPS == CPS - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[kt % STAGES]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += c[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += s[i];

"""
_CHUNK16 = ("constexpr int CHUNK = 32;", "constexpr int CHUNK = 16;")

# (substitutions, exact): each substitution (old, new) must match once
VARIANTS = {
    "base": ([], True),
    "chunk16": ([_CHUNK16], True),
    "interleaved": ([(_PRODUCTS, _INTERLEAVED)], True),
    "interleaved16": ([(_PRODUCTS, _INTERLEAVED), _CHUNK16], True),
    "separate": ([(_LOOP, _SEPARATE)], True),
    "separate16": ([(_LOOP, _SEPARATE), _CHUNK16], True),
    "group4": ([("constexpr int GROUP = 8;", "constexpr int GROUP = 4;")], True),
    "group16": ([("constexpr int GROUP = 8;", "constexpr int GROUP = 16;")], True),
    "stages2": ([("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")], True),
    # diagnostic: one tf32 pass (hi.hi^T alone)
    "one_pass": ([(_PRODUCTS, _ONE_PASS)], False),
    # diagnostic: the products of every even chunk after the first left
    # out (the loads stay; c0 is added again unchanged)
    "half_products": ([("      issue(q + 1, c0);\n",
                        "      if ((q + 1) % CPS == 0)\n"
                        "        mbar_wait(&full[(q + 1) / CPS % STAGES],\n"
                        "                  ((q + 1) / CPS / STAGES) & 1);\n"
                        "      wgmma_fence();\n      wgmma_commit();\n")], False),
    # diagnostic: no stores of the output
    "no_store": ([("        tma_store_2d(&map_o, S + b * TILE_BYTES, col0 + b * 32, row0);\n",
                   "        (void)b;\n"),
                  ("        tma_store_2d(&map_o, T + b * TILE_BYTES, row0 + b * 32, col0);\n",
                   "        (void)b;\n")], False),
}


def _declare(lib):
    lib.tdax_sqdist_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                     + [ctypes.c_longlong, ctypes.c_void_p])
    lib.tdax_sqdist_sm90.restype = ctypes.c_int


def build(names):
    """Compile each variant at once; load them."""
    sys.path.insert(0, str(HERE))
    from tdax_torch.ops import _build
    text = SOURCE.read_text()
    texts = {name: _build.substitute(text, VARIANTS[name][0]) for name in names}
    libs, reports = _build.build_variants(texts, OUT, _declare)
    for name, report in reports.items():
        print(json.dumps({"variant": name, **report}), flush=True)
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_sqdist: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as c
    c.import_port()
    from tdax_torch.ops import sqdist
    from tdax_torch.runtime import get_device

    device = get_device()
    libs = build(args.variants.split(","))
    names = list(libs)
    smi = c.nvidia_smi()
    x = torch.as_tensor(c.scale_cloud()[0], device=device)
    n, d = x.shape
    hi, lo, sq = sqdist.tf32_split_cuda(x)
    want = sqdist.pairwise_sq_euclidean_plain(x)
    x64 = x.double()
    sq64 = (x64 ** 2).sum(1)
    scale = sq64[:, None] + sq64[None, :]
    exact = (scale - 2.0 * (x64 @ x64.T)).clamp_min_(0.0)
    del x64
    stream = torch.cuda.current_stream().cuda_stream
    ldo = -(-n // 4) * 4

    def launch(name):
        out = torch.empty((n, ldo), dtype=torch.float32, device=device)
        rc = libs[name].tdax_sqdist_sm90(hi.data_ptr(), lo.data_ptr(), sq.data_ptr(),
                                         out.data_ptr(), n, d, ldo, stream)
        if rc != 0:
            raise RuntimeError(f"variant {name}: launch failed, cudaError {rc}")
        return out[:, :n]

    def err(got, ref):
        return float(((got.double() - ref).abs_().div_(scale)).max())

    errs, errs_f64 = {}, {}
    for name in names:
        got = launch(name)
        torch.cuda.synchronize()
        errs[name], errs_f64[name] = err(got, want.double()), err(got, exact)
        if VARIANTS[name][1] and (errs[name] > c.SQDIST_REL_TOL or not torch.equal(got, got.T)):
            raise AssertionError(f"variant {name}: error over scale {errs[name]:.3e} "
                                 f"or asymmetric")
        del got
    errs_f64["sqdist.cu"] = err(sqdist.pairwise_sq_euclidean_cuda(x, _kernel="fma"), exact)
    errs_f64["plain"] = err(want, exact)
    del want, exact, scale
    torch.cuda.empty_cache()
    order = names + names[::-1]
    ms = {name: [] for name in names}
    for name in order:
        ms[name].append(c.cuda_ms(lambda: launch(name), iters=ITERS))
    row = {"shape": [n, d], "nvidia_smi": smi, "max_err_over_scale": errs,
           "max_err_over_scale_vs_f64": errs_f64,
           "ms": {name: sum(v) / len(v) for name, v in ms.items()}, "ms_runs": ms,
           "split_ms": c.cuda_ms(lambda: sqdist.tf32_split_cuda(x), iters=ITERS),
           "ms_fma": c.cuda_ms(lambda: sqdist.pairwise_sq_euclidean_cuda(x, _kernel="fma"),
                               iters=ITERS),
           "library_ms": c.cuda_ms(lambda: torch.cdist(x, x,
                                                       compute_mode="use_mm_for_euclid_dist"),
                                   iters=ITERS),
           "bound_ms": c.sqdist_bound(n, d)[0]}
    print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
