#!/usr/bin/env python3
"""Probe variants of the Hopper int8 matmul kernel on one NVIDIA card.

    python3 probe_qmm.py [--variants base,no_fence,...] [--source NAME=PATH] [--iters 10]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is ``tdax_torch/ops/csrc/qmm_sm90.cu`` with a few text
substitutions (``VARIANTS``), compiled by nvcc with the port's flags into
``build/probe_qmm/`` (all at once) and loaded with ctypes beside the
port's own kernels.  At each site of ``SITES`` (shapes of
``chip_smoke.QMM_SITES``) every variant marked exact is held against the
plain version under chip_smoke's bf16 qmm tolerance, then all are timed
with CUDA events in turns (A B .. B A), beside qmm.cu and torch.matmul on
the weight pre-converted to bf16.  Variants marked diagnostic leave a
part of the work out on purpose: their error is reported, not gated.
``--source NAME=PATH`` adds a whole other source file with the same C
interface as one more exact variant.  A variant that fails to build is
reported and left out.  Prints one JSON line per site and the card's
name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "tdax_torch" / "ops" / "csrc" / "qmm_sm90.cu"
OUT = HERE / "build" / "probe_qmm"

SITES = [("vit.attn_qkv_w", 16384, 1664, 4992), ("vit.attn_proj_w", 16384, 1664, 1664),
         ("decoder.attn_qkv_w", 5120, 4096, 12288), ("decoder.mlp_proj_w", 5120, 11008, 4096)]

_CONVERT = """      convert_part(base + SM_Q + (j % A_STAGES) * Q_BYTES,
                   base + SM_B + (j % B_STAGES) * B_BYTES, ct);
"""
_FENCE = _CONVERT + "      fence_proxy_async();\n"
_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da0 = desc_sw128(x_addr + kk * 32, 0, 1024);
        const uint64_t da1 = desc_sw128(x_addr + 64 * 128 + kk * 32, 0, 1024);
        const uint64_t db = desc_sw128(b_addr + kk * 16 * 128, B_CHUNK, 1024);
        if (decltype(first)::value && kk == 0) {
          wgmma_m64n128k16_ss_tb_first(acc0, da0, db);
          wgmma_m64n128k16_ss_tb_first(acc1, da1, db);
        } else {
          wgmma_m64n128k16_ss_tb(acc0, da0, db);
          wgmma_m64n128k16_ss_tb(acc1, da1, db);
        }
      }"""
_NO_PRODUCTS = "      (void)x_addr;\n      (void)b_addr;"
_STORE = "        tma_store_2d(&map_o, ot + c * O_BOX, n0 + c * 64, row0);\n"
_LDS = "    const uint4 w = *reinterpret_cast<const uint4*>(q8 + k * BN + col16 * 16);\n"
_NO_LDS = ("    const uint4 w = make_uint4(k * 0x01010101u, col16 * 0x01010101u, "
           "(k ^ col16) * 0x01010101u, (unsigned)ct);\n")
_STS = """    *reinterpret_cast<uint4*>(row + ((j ^ (k % 8)) << 4)) = v0;
    *reinterpret_cast<uint4*>(row + (((j + 1) ^ (k % 8)) << 4)) = v1;
"""
_NO_STS = ("    if ((v0.x ^ v0.y ^ v0.z ^ v0.w ^ v1.x ^ v1.y ^ v1.z ^ v1.w) == 0x9E3779B9u) {\n"
           + _STS + "    }\n")

# (substitutions, exact): each substitution (old, new) must match once; a
# diagnostic variant may compute a wrong product on purpose (its error is
# reported, not gated)
VARIANTS = {
    "base": ([], True),
    # step kt - 1's stage released after step kt + 1 is converted
    "late_release": ([("""      wgmma_wait<1>();  // step kt - 1's products are in: its x and int8 are free
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[(kt - 1) % A_STAGES]);
      }
      if (kt + 1 < nk) {
        convert(kt + 1);
""", """      if (kt + 1 < nk) convert(kt + 1);
      wgmma_wait<1>();
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[(kt - 1) % A_STAGES]);
      }
      if (kt + 1 < nk) {
""")], True),
    # pairs stored straight from the accumulator fragment (4-byte stores)
    "direct_store": ([("""          *reinterpret_cast<__nv_bfloat162*>(ot + off) =
              __floats2bfloat162_rn(a[4 * nb + 2 * h] * sc.x, a[4 * nb + 2 * h + 1] * sc.y);""",
                       """          (void)off;
          const int row = m0 + cw * 128 + r;
          if (col < p.N && row < p.M)
            *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
                __floats2bfloat162_rn(a[4 * nb + 2 * h] * sc.x, a[4 * nb + 2 * h + 1] * sc.y);"""),
                      (_STORE, "        (void)c;\n"),
                      ("  const float* s;\n", "  const float* s;\n  __nv_bfloat16* out;\n"),
                      ("  Params p{s, M,", "  Params p{s, static_cast<__nv_bfloat16*>(out), M,")],
                     True),
    # diagnostic: the conversion's writes not fenced for the async proxy
    "no_fence": ([(_FENCE, _CONVERT)], False),
    # diagnostic: the conversion's arithmetic without its shared loads
    # (each chunk made from the thread's indices)
    "no_lds": ([(_LDS, _NO_LDS)], False),
    # diagnostic: ... without its shared stores (a store only where the
    # chunk's bits XOR to a constant, which random weights never do)
    "no_sts": ([(_STS, _NO_STS)], False),
    # diagnostic: the arithmetic alone
    "alu_only": ([(_LDS, _NO_LDS), (_STS, _NO_STS)], False),
    # diagnostic: no stores
    "no_store": ([(_STORE, "        (void)c;\n")], False),
    # diagnostic: the loads and the stores alone (no conversion, no products)
    "tma_only": ([(_FENCE, "      fence_proxy_async();\n"), (_PRODUCTS, _NO_PRODUCTS)], False),
    # diagnostic: no conversion (the bf16 tiles hold whatever they held)
    "no_convert": ([(_FENCE, "      fence_proxy_async();\n")], False),
    # diagnostic: no products (the consumers convert, wait and release only)
    "no_wgmma": ([(_PRODUCTS, _NO_PRODUCTS)], False),
}


def _declare(lib):
    lib.tdax_qmm_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                  + [ctypes.c_longlong, ctypes.c_void_p])
    lib.tdax_qmm_sm90.restype = ctypes.c_int


def build(names, sources):
    """Compile each variant (a name of VARIANTS, or of ``sources``: a whole
    other source file) at once; load them."""
    sys.path.insert(0, str(HERE))
    from tdax_torch.ops import _build
    text = SOURCE.read_text()
    texts = {name: Path(sources[name]).read_text() if name in sources
             else _build.substitute(text, VARIANTS[name][0]) for name in names}
    libs, reports = _build.build_variants(texts, OUT, _declare)
    for name, report in reports.items():
        print(json.dumps({"variant": name, **report}), flush=True)
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                        help="also time another whole source file (exact) as variant NAME")
    args = parser.parse_args(argv)
    sources = dict(a.split("=", 1) for a in args.source)
    import torch
    if not torch.cuda.is_available():
        print("probe_qmm: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as c
    c.import_port()
    from tdax_torch.models.qwen_vl.quantize import quantize_weight
    from tdax_torch.ops import quant_matmul as qm
    from tdax_torch.runtime import get_device

    device = get_device()
    libs = build(args.variants.split(",") + list(sources), sources)
    names = list(libs)
    smi = c.nvidia_smi()
    gen = torch.Generator(device=device).manual_seed(97)
    for site, m, k, n in SITES:
        x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        want = qm.quant_matmul_plain(x, w["q"], w["s"]).float()
        limit = want.abs() * c.QMM_BF16_RTOL + c.QMM_BF16_ATOL_OF_MAX * float(want.abs().max())
        stream = torch.cuda.current_stream().cuda_stream

        def launch(name):
            out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
            rc = libs[name].tdax_qmm_sm90(x.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(),
                                          out.data_ptr(), m, n, k, x.stride(0), stream)
            if rc != 0:
                raise RuntimeError(f"variant {name}: launch failed, cudaError {rc}")
            return out

        errs = {}  # every variant's; only an exact one's is gated
        for name in names:
            err = (launch(name).float() - want).abs_()
            torch.cuda.synchronize()
            errs[name] = float(err.max())
            exact = name in sources or VARIANTS[name][1]
            if exact and float((err - limit).max()) > 0:
                raise AssertionError(f"variant {name} at {site}: max err {errs[name]}")
        order = names + names[::-1]
        ms = {name: [] for name in names}
        for name in order:
            ms[name].append(c.cuda_ms(lambda: launch(name), iters=args.iters))
        dense = (w["q"].float() * w["s"]).to(torch.bfloat16)
        row = {"site": site, "shape": [m, k, n], "nvidia_smi": smi, "max_abs_err": errs,
               "ms": {name: sum(v) / len(v) for name, v in ms.items()},
               "ms_runs": ms,
               "ms_qmm_cu": c.cuda_ms(lambda: qm.quant_matmul(x, w["q"], w["s"], _kernel="mma"),
                                      iters=args.iters),
               "library_ms": c.cuda_ms(lambda: torch.matmul(x, dense), iters=args.iters),
               "bound_ms": c.qmm_bound(m, k, n, 2)[0]}
        print(json.dumps(row), flush=True)
        del x, w, want, limit, dense
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
