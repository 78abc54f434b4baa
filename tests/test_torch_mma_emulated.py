"""The bf16 policy's tensor-core K4/K5 (csrc/coupling_mma.cuh) run on the
CPU through a host emulation of the warp primitives they use
(tests/mma_emulation.h: each CUDA thread a std::thread, ldmatrix and
mma.sync by the PTX ISA's fragment layouts), against their plain versions
`tile_flow` / `tile_flow_bwd` under the policy.

The kernels' sources are compiled as they are, with g++, after three
mechanical rewrites: a launch ``k<<<grid, threads, smem, stream>>>(...)``
becomes ``emu_launch(k, grid, threads, smem, stream, ...)``, the inline-PTX
fragment helpers give way to the emulation's, and cp.async copies at once.
The shared-memory cap and the warps a CTA are variables here, so that a
stack that would be staged whole can be staged a coupling at a time, and
a row can be run at each CTA size the kernels are built for. The
policy's plan (`coupling_cuda.mma_plan`, the C entry `coupling_mma_plan`)
is asked of the same library.

The emulated tensor core sums as chip_smoke.py phase 59 measured the
card's (tests/mma_emulation.h's `tc_sum`: the addends aligned to the
largest, each cut toward zero below 2^(E − 25), the sum normalised toward
zero), bit for bit on the probe's cases (`CARD_MMA_BITS`), and the kernels
round each product to nearest from two passes (`mma_rn`).

Tolerances: the plain version (the CPU's float32 matmul) sums in another
order. So values agree to float32 roundoff (rtol/atol 1e-4 on y, ld and
gx · N), and a bfloat16 rounding downstream can flip, moving a term of a
weight gradient by 2^-8 of its scale: each gradient within 1e-3 relative
L2 (a few flips among 40 rows). A fault of the fragments' layout moves
them by their own size. Held to the float64-summed witness
(`chip_smoke.witness_gate`, phase 47's gate), every output and weight
gradient stands within DEEP_WITNESS_FACTOR times the witness's error from
the plain version, plus LEAF_FLOOR (measured at most 1.6 times); the
kernels before the products were rounded to nearest (the bias the forward's
addend, the backward's products moved half an ulp) stood 19,838 times it
on d=5 inverse, seed 2, one row's y 3.8e-3 off.
"""

import contextlib
import ctypes
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import normalizingflows_torch as nft
from normalizingflows_torch.experimental import coupling_cuda as cc
from normalizingflows_torch.ops import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
VALUE_TOL = (1e-4, 1e-4)   # rtol, atol of y, ld and gx · N
LEAF_REL = 1e-3            # relative L2 error of each weight gradient
# (d, hidden widths, blocks): the demo's H = 16; H = 32 (two k16 chunks a
# layer); d = 8 with 4 layers (n_A = n_B = 4, the head's whole n8 tile);
# d = 5 (n_A 3 and 2)
SHAPES = {"demo": (2, (16, 16), 3), "h32": (2, (32, 32), 2),
          "d8": (8, (32, 32, 32), 1), "d5": (5, (8, 8), 2)}
DEMO_WIDTHS = [1, 16, 16, 1] * 2  # the C interface's, per group n_B ... n_A
# chip_smoke.py phase 59's results on an NVIDIA H100 80GB HBM3 (700 W): one
# mma.sync.m16n8k16 a case on `chip_smoke.mma_probe_cases()` (402 cases,
# seed MMA_PROBE_SEED), each result's float32 bits in hex
CARD_MMA_BITS = (
    "4210ac40421128504217af20420982504218d49042076cdf4210a2c64200beb6"
    "41ecc76c42043f6d42102c134203d98b420e5fd042213c4240c70ba44256ce4c"
    "c36815b2c39e824ac2166230c2069f40c20c4f30c2225ac0c2120f40c21271ef"
    "c202ea28c21906f5c1f8dcaec20efeacc20da460c2180662c217414bc200f985"
    "c2736f4ac1067fbe43eab557c3c4a1613f9d3e983f8a930c3f7b96003f925bb6"
    "3f20c29f3f6ab2c1bf486020bf7f22e0bf94b3a8bf7c2ddebf8f2fd3bf7b4ec9"
    "bde5dac03ebb3720bddaa180bec175793eede513bf4e6b643d9f26943d66e320"
    "3db7cc203d87f4a03d2262d83d631480bd795af0bd59e580bda09800bd9a3828"
    "bd616588bd15d8903cadb270bc2b4f003cdec510ba9c0500bcb0e470bd2d7af0"
    "3abe1e003b7f40003b502f003b8297803b6886803b951f80bb801e80bb485280"
    "bb557280bb8b1000bb709180bba99f803adc1200ba42d6003b414680b9cf4000"
    "ba925a00ba6db00039989400392be8003986c8003966e80039a59400396f8800"
    "b94b4800b96bd000b952e000b9110000b9810c00b9778800b89b800038642000"
    "b81de00038c30000381f2000b81e400037168000374980003742800037268000"
    "3786000037918000b77b0000b7278000b74e8000b74b8000b74a0000b7600000"
    "b5fc0000363a0000b6a7000035280000b5400000b6cf00003528000035580000"
    "35000000353000003510000035500000b58c0000b4f00000b5200000b5480000"
    "b5380000b5480000340000003440000033000000b4e000003300000033c00000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000420f2054404a4f1a42055e783fdd0a7b4221c1d6bff7f9c0"
    "41e9449dc11c6a5d42776d1141fe29f84101fb06c1cd695042de423e42dbbe3e"
    "c206fbbcc2e3974b43987e3b43b99d19c3839606c3e278b244cf27a644b681e6"
    "c4a188c4c4b7484745d0cf1945fe4544c5dc4097c5bc80f7469d3f6a469df68c"
    "c6ba96dcc6ff8a5347e7d8bd47a64515c7c7dcb1c7c4bcd548d3e8c14882df8c"
    "c8be5b58c8d18be749dd3afb4985e1cfc9af438ac98be62e4ab1fa5c4af20f2a"
    "ca913df1cabf13bf4bb21a1e4bfdcd92cbd0e590cbb9f2654ca29d354cb72173"
    "ccd19a9dcce5acf34de6031f4d9f5d37cdccfec9cdd0ad444ef893bf4eaa8bb6"
    "ce9d9498ce89b3113fe250003ff5a403403162003fb23e024004120140095200"
    "3fe8680240178001401288ff4001e3ff401c4fff4020ffff4001c5fe3f8f57ff"
    "40063cfe403493ff3fb700003fef87fd3ff8ebff404b03ff40417d0040505bff"
    "3ff4b9ff3fc2d5ffbff339ffc02a9bffbfea7dffc00b13fec0304fffc02d3fff"
    "c03ea4ffc02deffec0319200bfd67402c00da401bff29402c02ea802c0228702"
    "bfd60c01c005e000c029f800c02ca500bf97fc02c050d700c03cffffc0117d00"
    "c0121700bfe5ce0144b046ba449073d5c41e7c7cc3b9bb01447b8888c63e18cd"
    "44ec97cd451d0188c519add8465c4e10c62bb38a4412a57fc2ac7e08c34c30c6"
    "c49d1ee643260676c24a5839c489584944de18a0c4209a9e448bf1ffc40d417a"
    "458d700844cad1c8c43c48ce430c562fc598d3d5c3c5de4cc520825cc5498944"
    "c5a4dfdf459cce1346436c4445c399dec5a1cc0bc4ae578e4431ff37449d3ae0"
    "c48a7e2844073769c4537417459ebe0045a7560ec5261e5ac4154d2743f664ac"
    "44265cfdc4ad3fb8444bb0d944a823a5c3d330fa43c28b57429a413440d326fe"
    "c4ffdc51438575c843be988341f80d6043e78ed6c60621b344cd24aa45003336"
    "4511dd61c22faae6452a8036c616c17ec39e7773457427e045cf1e2bc5d1e206"
    "4522d9e044030e00c32ed902c561a7504520d9f044c59936443dd03ec4209c09"
    "c40f702043c8ae0ec485ad9343b59846c657392e432f399b43365686438f834b"
    "45ca859cc36f02b044b71abac4d6e029c4f45de4c50ff9cac285ccc445cedeab"
    "46164ffec43fc285c4298d7ac3b05cfec4db7fc4c30fcf1ec5f38761c48851a3"
    "c3cd53ea45a3c624c390355545875570c49aad0644bb97b1c49b14e3c1087a44"
    "45ee1e38c2fdc8fdc54bb98f464c1ba444daa098c400e3f1436c97cbc4cf3eec"
    "4407072743abfe4dc55751e344f2fefd450d6d66c2f0ed0bc548160644cddba2"
    "450edb66c2bdc88c")
# the one model of the sum (`chip_smoke.tc_models`) that gives all of them
CARD_MODEL = dict(group=16, extra=2, align="rz", norm="rz", c="joined",
                  exps="nominal")
# chip_smoke.py phase 60's results on the same card: one mma.sync.m16n8k16
# .f64 a case on `chip_smoke.dmma_probe_cases()` (384 cases, seed
# DMMA_PROBE_SEED), each result's float64 bits in hex; four m16n8k4 .f64
# in k order gave the same bits on every case
DMMA_CARD_BITS = (
    "40c7351a012e000040beb3b2a3560000c0becd7f57550000c070d54fd5e80000"
    "4091c4aa65d60000c0b765e8c0fa000040b58ebf4adcc000c0d5fee71fd84000"
    "c0c07a90ee2b0000c0cece3b2d63a0004064a3fe7d50000040b6f8da842b8000"
    "c0bb0ab4ecd2000040d3c6b59397800040150f1b3800000040b0860ee5be0000"
    "c0bd11c94001800040c220042023400040b97b6004d40000c0c5a9ad94722000"
    "40702645cf680000c0c06cd751518000c059a15aaa00000040945e656dd00000"
    "c095382b75d80000c0b2bdb06db8000040c582ab5b4cc00040c146ce50d98000"
    "409c3d8df0600000409923d2a4b80000407925c337e4000040d6d7a3ede70000"
    "40af6742514c0000c0a562c905e000004098c40a7f5400004085f6ca37bc0000"
    "c0bf917d97728000c0932a7427b2000040c7322bfbf74000c0b161ec047f0000"
    "c0c8cc8a56150000c0acf149489280004093c586d70c0000c0c407cdfc800000"
    "40844e5705f20000c0c4bfebc8b7000040cfa9d0a5f00000c0c35fcad7280000"
    "c0a88e8eab8a000040c6831b15480000c08ed3fc6908000040a6bec6edec0000"
    "40c0dbbc30d6e000c0af8ab1cd080000c0945fd5f1180000c0c0998891980000"
    "408382b1c6100000c0c440cd73fe8000c0c5ec80ce8f0000c0c9345186280000"
    "c0db1af86ddfc000c0e0266324850000c0c3fe9265ad000040ce29f0fec00000"
    "42868cb81bcd6ec942646fee1a65077fc253f1874020386b426d84037dba4c29"
    "c2673f6dfdd51506c21325485dd6b420c24da09c56f56f91c19d8bc8c3b450f9"
    "c1ebbd2df360b6ff4268f3192e0b23a042776527de8daed742269b2800801e10"
    "c230cd576db0c5cc4258d70f7993f2ea426f97b00556d7bac27f96b453b907fd"
    "c23eb2cdda670b04428383be469590114208798c4ec50b50c28bda13bea6238e"
    "42785bb7273418c842062970ce56e715c275864ddee8c2c541fd0d66141afc41"
    "c26a62d5cea1098541ea7c69260de73ec283047fe1c8a2f3c20180dd646e8241"
    "428350bc2f2567c441f2592a5ecb97d6414f17387e4deee5c268a3be9c25c9e4"
    "423a5b865115bc7bc2531cd395f979314260b73aec3ab286c214cc23553703a4"
    "421aff1a155d324b426fd983cfcd4c894164d54999f9c877c27d7fb7a675c9e3"
    "42180f4932de6342c233ea0ee3f3a4f4423e08d0e4693469c1f29a0a96d0c87f"
    "42802bcb1f006edbc24eac35d9c7083bc236c0c2e3c6d88fc24ca208963602dc"
    "425b6c0437d1bde9422011a032213a6fc26a8d9787d5da64c144889a981eac10"
    "42126f8b127f5346c232eea57c02d9794238114c8aef1996427a255269f3fa6c"
    "c255ad387408dc68c277e354c152d91a4205dc1c090e3c4a427194eb2582fdf1"
    "422163d51e1f4bbec268fdadb64567c8c1fb58557d76372a428309f2f896b4cf"
    "3fb2e13580000000bf299ace00000000be977796000000003e2bf30f00000000"
    "bdb335c1000000003cc07200000000003c906c7c00000000bc13306c00000000"
    "bf57c220000000003f2b4eb800000000bea9645400000000be20a48000000000"
    "3dac304b00000000bd2b3a3a00000000bc90442c000000003c1c180800000000"
    "bfa95d19000000003f1f188c000000003eaca21400000000be29fd5d00000000"
    "bd649db0000000003d27d22400000000bc74be00000000000000000000000000"
    "3fb2564080000000bf232340000000003e88a470000000003e2ea11600000000"
    "bdb0ca00000000003d1bd154000000003ca6844200000000bc21b85900000000"
    "3fa05067000000003f30a3ba00000000beb2574e00000000bdfc592800000000"
    "3db1f7f200000000bd2e47c8000000003c82c160000000003bdc3b0000000000"
    "bfb39b4e00000000bf005f54000000003eaae14200000000be29f82000000000"
    "3d84d7e8000000003d267c2100000000bc86c440000000003c01358000000000"
    "3fa94a5a00000000bf2b7225000000003ea2fa58000000003e2a153f00000000"
    "bdb367e0000000003cc00000000000003c8ff60c000000000000000000000000"
    "bf8d1f28000000003f2b468000000000beb5ab21800000003e201efa00000000"
    "3da583c000000000bd24a000000000003c86cc90000000003c1928bc00000000"
    "c2762dc85ffe1fa3c10489d4d0600000c3a123d5e0000000414df13b216c0000"
    "c425a53ba0000000c194949a969e600040baa07058000000c15f7537bc4f0000"
    "441893f040000000407f670f20000000c123448602200000c305f124a000004c"
    "c0bab0f6c40000004140f291d5a20000c1bc1ff720213c00c21b720bdff4e900"
    "40b7a619e800000042124ec1605537e0445b870d40000000444513a560000000"
    "4104dc4ea1400000c2e03247bffffdc5c374ab8e4000000041e2cfdba0560d00"
    "c45e9c024000000041153d2d271000004452630c20000000c2190bca1fd08ba0"
    "41cc88cbb3282e004316ebb75fffffe3c41b8a904000000044001cb2a0000000"
    "c2d1a7d75ffff6bac2140d97e0129bf0c2c4566bffffed72c2995e88600017f8"
    "c21349c3ff7f2490c360d3a6400000004044b75cb4000000c21683167ffe1ed0"
    "40b43ff4540000004086e246a00000004111884062700000c40eb24140000000"
    "c1bcf11d18facc00bfedb57700000000c3bdeed46000000043eb9ae300000000"
    "c0a3c822b800000041ef15251d08d200c0635cf500000000407406a6e0000000"
    "43fa9174c0000000c14093ee68560000420d3f0d6109bc004413d6ed40000000"
    "404a7e7140000000c05d9dc840000000c081c62b8000000041c31b1c40f11000"
    "412e4568b3500000c1b474ff24cbe000c1df55bf17ccef00c1498c1029f00000"
    "800000000000413d0000000000000cb88000000000006d930002d6bffffeb219"
    "0000000000000cc20000000000000910000000000000b057800a0dffffff36b0"
    "800000000000111a8000000000001d860000000000001465000fab8000024f95"
    "80000000000043cd00000000000006b4000000000000129e000b7bfffffe63b7"
    "8000000000001c7d00000000000019dd800000000000026400086980000210d7"
    "8000000000000541800000000000076880000000000024b10002d6c000002c79"
    "800000000000028d00000000000014b580000000000006740004b2800001a4c5"
    "000000000000bbca800000000000208580000000000008648005fb4000002247"
    "800000000003843000000000000927e780000000000944cb8015dc3ffffac0b9"
    "000000000005b0e98000000000077f0800000000000f3cee80094a800003da23"
    "00000000000b3869800000000000db8680000000000fa35100036d7ffffdcba2"
    "8000000000053512000000000003536c800000000001fd318006b93ffffcd711"
    "80000000000c7b1b8000000000056dbd80000000000137270016d7bfffff8d7d"
    "80000000000dd2bf800000000007a5b080000000000e065a8004bd3ffffb33c9"
    "80000000000695e480000000000a7ce080000000000f4dc5800cf83ffffe4ebc"
    "80000000000ca79b80000000000259cb00000000000990c70001e7800002903c"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
    "0000000000000000800000000000000000000000000000000000000000000000"
)
# the one model of the float64 sum (`chip_smoke.dmma_models`) that gives
# all of them: a chain of fused multiply-adds from c, k in order
CARD_DMMA_MODEL = dict(group=1, norm="rn", c="joined")
HELPERS = ("smem_at", "pack2", "lo_of", "hi_of", "ldsm_x2_t", "ldsm_x4_t",
           "mma16816", "dmma16816", "dmma1684")
CP_ASYNC = """#pragma once
namespace {
template <typename T>
inline void cp_word(T* dst, const T* src, bool valid = true) {
  *dst = valid ? *src : T(0);
}
inline void cp_chunk(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_commit() {}
inline void cp_wait_all() {}
inline void cp_wait_one() {}
}  // namespace
"""
MAIN = """#include "mma_emulation.h"
thread_local dim3s threadIdx, blockIdx;
dim3s blockDim, gridDim;
__attribute__((aligned(16))) unsigned char coupling_smem[kEmuSmem];
Barrier g_block_bar;
Warp g_warps[8];
#include "coupling_bf16.cu"
extern "C" void emu_set_cap(int bytes) { kMmaMaxSmem = bytes; }
extern "C" void emu_set_warps(int w) { kMmaWarps = w; }
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_ab():
    spec = importlib.util.spec_from_file_location(
        "torch_ab", ROOT / "benchmarks" / "torch_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_bits():
    text = "".join(CARD_MMA_BITS)
    return np.array([int(text[i:i + 8], 16) for i in range(0, len(text), 8)],
                    np.uint32)


def _card_dmma_bits():
    text = "".join(DMMA_CARD_BITS)
    return np.array([int(text[i:i + 16], 16) for i in range(0, len(text), 16)],
                    np.uint64)


def _rewrite(text: str, name: str, edits=()) -> str:
    text = re.sub(r"(\w+(?:<[^;{}]*?>)?)<<<(.*?)>>>\(",
                  r"emu_launch(\1, \2, ", text, flags=re.S)
    text = re.sub(r"#include <(cuda_bf16|cuda_runtime|cooperative_groups)"
                  r"\.h>\n", "", text)
    if name == "mma_frag.cuh":
        for fn in HELPERS:
            text, k = re.subn(
                rf"__device__ __forceinline__ \w+ {fn}\(.*?\n\}}\n", "",
                text, flags=re.S)
            assert k == 1, fn
    if name == "coupling_mma.cuh":
        for name in ("kMmaMaxSmem", "kMmaWarps"):
            text, k = re.subn(rf"constexpr int {name} = ",
                              f"int {name} = ", text)
            assert k == 1, name
        text, k = re.subn(r"static_assert\(kMmaWarps.*?\);\n", "", text)
        assert k == 1
        for a, b in edits:
            assert a in text, a
            text = text.replace(a, b)
    return text


def build_emulated(out: Path, main: str, entries, opt: str = "-O1",
                   edits=()):
    """csrc/'s sources rewritten for the host emulation into ``out`` and
    ``main`` (the emulation's globals, then the sources it includes)
    compiled there with g++: the library, with the C interface's types on
    ``entries``; ``edits`` are (old, new) replacements in
    coupling_mma.cuh. Skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation")
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (out / src.name).write_text(
                CP_ASYNC if src.name == "cp_async.cuh"
                else _rewrite(src.read_text(), src.name, edits))
    shutil.copy(ROOT / "tests" / "mma_emulation.h", out)
    (out / "main.cpp").write_text(main)
    lib = out / "libemulated.so"
    done = subprocess.run([gxx, "-std=c++17", opt, "-fPIC", "-shared",
                           "-pthread", "-Wno-unknown-pragmas", "-I", str(out),
                           "-o", str(lib), str(out / "main.cpp")],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for name in entries:
        getattr(lib, name).argtypes = _build.ENTRIES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The emulated kernels' library, built with g++ from csrc/."""
    lib = build_emulated(tmp_path_factory.mktemp("mma_emulation"), MAIN,
                         ("coupling_fwd_f32_cbf16", "coupling_bwd_f32_cbf16",
                          "coupling_mma_plan"))
    lib.emu_set_cap.argtypes = [ctypes.c_int]
    lib.emu_set_warps.argtypes = [ctypes.c_int]
    yield lib


# the other design of the float64 products as benchmarks/torch_ab.py
# --levers builds it (`LEVERS`): a bfloat16's widening to float64 by
# integer bit operations in place of cvt
OTHER_DESIGN = tuple(_torch_ab().LEVERS.values())


@pytest.fixture(scope="module")
def emu_other(tmp_path_factory):
    """The emulated kernels of the other design (OTHER_DESIGN)."""
    yield build_emulated(tmp_path_factory.mktemp("mma_emulation_levers"), MAIN,
                         ("coupling_fwd_f32_cbf16", "coupling_bwd_f32_cbf16"),
                         edits=OTHER_DESIGN)


@pytest.fixture
def planned(emu, monkeypatch):
    """`coupling_cuda.mma_plan` answered by the emulated library."""
    monkeypatch.setattr(_build, "library", lambda: emu)
    return emu


@contextlib.contextmanager
def _warps(emu, w):
    """K4 and K5 at w warps a CTA, then the build's 4 again."""
    emu.emu_set_warps(w)
    try:
        yield
    finally:
        emu.emu_set_warps(4)


def _stack(shape, seed=0):
    """A perturbed fused RealNVP under the policy, its selections, leaves
    and the C interface's int arrays."""
    d, hdims, blocks = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    flow = nft.realnvp(g, d, hdims, nlayers=blocks, fused=True,
                       compute_dtype=BF, device="cpu")
    fb = flow.bijector.bijectors[0]
    with torch.no_grad():
        for p in fb.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    sels = cc._sels(fb.idx_even, fb.idx_odd, d)
    leaves = [t.detach().contiguous() for t in cc._leaves(fb.groups)]
    widths = []
    for grp in ("even", "odd"):
        widths += [fb.groups[grp]["s"][0][0].shape[1]] + [
            W.shape[2] for W, _ in fb.groups[grp]["s"]]
    c_int = ctypes.c_int
    args = ((c_int * len(widths))(*widths),
            (c_int * (2 * d))(*(sum(sels, ()))))
    return fb, sels, leaves, args


def _inputs(d, n, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
            / n,
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)) / n)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _run(emu, stack, x, gy, gld, inverse, warps=4, k5=True):
    """K4 (and K5) at ``warps`` warps a CTA through the C entries: (y, ld,
    gx, weight grads)."""
    with _warps(emu, warps):
        return _entries(emu, stack, x, gy, gld, inverse, warps, k5)


def _entries(emu, stack, x, gy, gld, inverse, warps, k5):
    _, _, leaves, (widths, idx) = stack
    n, d = x.shape
    blocks, depth = leaves[0].shape[0], len(leaves) // 8
    y, ld = torch.full_like(x, np.nan), torch.full((n,), np.nan)
    assert emu.coupling_fwd_f32_cbf16(
        x.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, blocks, depth,
        widths, idx, _ptrs(leaves), 0, int(inverse), None) == 0
    if not k5:
        return y, ld
    n_ctas = -(-n // (16 * warps))
    gx = torch.full_like(x, np.nan)
    grads = [torch.full_like(t, np.nan) for t in leaves]
    scratch = torch.empty(n_ctas * sum(t.numel() for t in leaves))
    assert emu.coupling_bwd_f32_cbf16(
        x.data_ptr(), gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
        scratch.data_ptr(), n, d, blocks, depth, widths, idx, _ptrs(leaves),
        _ptrs(grads), n_ctas, int(inverse), None) == 0
    return y, ld, gx, grads


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_policy_kernels_match_their_plain_versions(emu, shape,
                                                            inverse):
    """y, ld, gx and every weight gradient at 40 rows (two CTAs of 32
    rows, the second ragged), forward and inverse."""
    stack = _stack(shape)
    fb, sels = stack[0], stack[1]
    x, gy, gld = _inputs(SHAPES[shape][0], 40)
    y, ld, gx, grads = _run(emu, stack, x, gy, gld, inverse, 2)
    y_p, ld_p = cc.tile_flow(x, fb.groups, sels, inverse, BF)
    gx_p, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse, BF)
    for a, b in ((y, y_p), (ld, ld_p), (gx * 40, gx_p * 40)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   rtol=VALUE_TOL[0], atol=VALUE_TOL[1])
    for i, (a, b) in enumerate(zip(grads, cc._leaves(tree))):
        assert _rel(a, b) <= LEAF_REL, (i, _rel(a, b))


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_rows_keep_their_bits(emu, inverse):
    """A row's y, ld and gx do not depend on where it lands: at 1, 2, 4
    and 8 warps a CTA, with CTAs that walk several tiles (K4's grid is
    the emulation's 3 SMs), and split at a 16-row boundary into two
    launches, the bits of one launch at 4 warps; two runs agree in every
    output, the weight gradients too."""
    stack = _stack("demo")
    x, gy, gld = _inputs(2, 300)
    want = _run(emu, stack, x, gy, gld, inverse)
    again = _run(emu, stack, x, gy, gld, inverse)
    for a, b in zip(want[:3] + tuple(want[3]), again[:3] + tuple(again[3])):
        assert torch.equal(a, b)
    for warps in (1, 2, 8):
        got = _run(emu, stack, x, gy, gld, inverse, warps)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), warps
    parts = [_run(emu, stack, x[a:b].contiguous(), gy[a:b].contiguous(),
                  gld[a:b].contiguous(), inverse)
             for a, b in ((0, 144), (144, 300))]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), want[i])


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_one_slot_gives_the_resident_bits(planned,
                                                          inverse):
    """Under a smaller shared-memory cap the demo's stack is staged a
    coupling at a time, and K5's partial sums go to device memory (K5
    under 50,000 bytes: resident it needs 74,112 and 89,520 with its
    partial sums, with one slot 38,752; K4 under 20,000: 48,768 against
    13,408), and every output keeps its bits; at one warp a CTA K5's three
    CTAs each walk several tiles, staging each coupling again, and y, ld
    and gx keep theirs."""
    emu = planned
    stack = _stack("demo")
    x, gy, gld = _inputs(2, 100)
    want = _run(emu, stack, x, gy, gld, inverse)
    assert cc.mma_plan(2, 3, 3, DEMO_WIDTHS, True) == (64, 89520)
    assert cc.mma_plan(2, 3, 3, DEMO_WIDTHS) == (64, 48768)
    try:
        emu.emu_set_cap(50000)
        got = _run(emu, stack, x, gy, gld, inverse)
        walked = _run(emu, stack, x, gy, gld, inverse, 1)
        emu.emu_set_cap(20000)
        y, ld = _run(emu, stack, x, gy, gld, inverse, k5=False)
    finally:
        emu.emu_set_cap(227 * 1024)
    for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        assert torch.equal(a, b)
    for a, b in zip(walked[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(y, want[0]) and torch.equal(ld, want[1])


def _widths(d, depth, hidden):
    """The C interface's widths: per group n_B, the hidden widths, n_A."""
    return [d - d // 2, *([hidden] * (depth - 1)), d // 2] * 2


# (d, blocks, depth, hidden, K5?, rows, bytes) of the bf16 policy's
# K4/K5 (`mma_plan`) at 4 warps a CTA, 64 rows. One net staged in float64:
# layer 0's Wᵀ H×4, each hidden layer's H×(H+4), the head's 4×(H+4), then
# (depth−1)·H + 8 float32 biases: 8·(64 + 320 + 80) + 4·40 = 3,872 bytes
# at H=16, depth 3; 8·(128 + 1,152 + 144) + 4·72 = 11,680 at H=32;
# 8·(128 + 2·1,152 + 144) + 4·104 = 21,024 at H=32, depth 4. A coupling is
# two nets; every coupling is staged where the whole fits in 227 KB, else
# one. Then each warp's x rows, 64 rows of 9 words (2,304 bytes); K5 also
# the cotangent rows (2,304), every coupling's input (2·blocks·64·d
# words), the kept x_B (64 rows of 16 bytes), each net's hidden levels
# (2·(depth−1)·64·(H+8)·2 bytes) and two layers' G (2·64·(H+8)·2) and bias
# partials (2·4·H words); then, with one slot, one landing slot of a
# coupling's float32 words at the bounds, 2·(4H + H + (depth−2)(H² + H) +
# 4H + 4) words (10,784 bytes at H=32; 19,232 at depth 4), none for a
# resident stack (staged straight from device memory); and K5's partial
# weight gradients where they fit (the demo's 3,852 words).
@pytest.mark.parametrize("d,blocks,depth,hidden,bwd,rows,nbytes", [
    # the demo: 6 couplings of 7,744 bytes, K5 with its partial sums
    (2, 3, 3, 16, False, 64, 6 * 7744 + 2304),
    (2, 3, 3, 16, True, 64,
     6 * 7744 + 2 * 2304 + 3072 + 1024 + 12288 + 6144 + 512 + 4 * 3852),
    # one block of the demo's shape: 2 couplings, whole
    (2, 1, 3, 16, False, 64, 2 * 7744 + 2304),
    # the reference default: 20 couplings of 23,360 bytes do not fit, one
    # does; its 46,120 partial sums do not fit beside it
    (2, 10, 3, 32, False, 64, 23360 + 2304 + 10784),
    (2, 10, 3, 32, True, 64,
     23360 + 2 * 2304 + 10240 + 1024 + 20480 + 10240 + 1024 + 10784),
    # d=8 with [32,32,32]: 20 couplings of 42,048 bytes do not fit, one
    # does
    (8, 10, 4, 32, False, 64, 42048 + 2304 + 19232),
    (8, 10, 4, 32, True, 64,
     42048 + 2 * 2304 + 40960 + 1024 + 30720 + 10240 + 1024 + 19232),
])
def test_policy_plan_matches_hand_counts(planned, d, blocks, depth, hidden,
                                         bwd, rows, nbytes):
    assert cc.mma_plan(d, blocks, depth, _widths(d, depth, hidden),
                       bwd) == (rows, nbytes)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_policy_plan_rows_follow_the_warps(planned, warps):
    """A CTA is 16 rows a warp; at the demo K4's bytes are the staged stack
    (fixed) and the warps' x rows (576 bytes a warp)."""
    with _warps(planned, warps):
        plan = cc.mma_plan(2, 3, 3, DEMO_WIDTHS)
    assert plan == (16 * warps, 6 * 7744 + 576 * warps)


@pytest.mark.parametrize("d,depth,hidden", [(9, 3, 16), (2, 5, 16),
                                            (2, 3, 33)])
def test_policy_plan_refuses_a_stack_outside_the_kernels(planned, d, depth,
                                                         hidden):
    with pytest.raises(RuntimeError, match="coupling_mma_plan"):
        cc.mma_plan(d, 3, depth, _widths(d, depth, hidden))


@pytest.mark.parametrize("nlayers,cap", [(30, None), (31, 30), (32, 30),
                                         (33, 30)])
def test_policy_backward_shared_memory_cap(planned, nlayers, cap):
    """The policy's K5 keeps every coupling's input for its CTA's 64 rows:
    at d=8 with [32,32,32] conditioners (one coupling staged at a time in
    float64, 108,896 bytes, and 4,096 a block) it takes at most 30 blocks
    (32 while the weights were staged in bfloat16). Past the cap the
    backward's check raises; a forward alone, or a stack within the cap,
    goes on to the device check."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 8, (32, 32, 32),
                       nlayers=nlayers, fused=True, compute_dtype=BF,
                       device="cpu")
    fb = flow.bijector.bijectors[0]
    sels = cc._sels(fb.idx_even, fb.idx_odd, 8)
    x, leaves = torch.zeros((300, 8)), cc._leaves(fb.groups)
    kw = dict(compute_dtype=BF)
    with pytest.raises(ValueError, match="CUDA device"):
        cc._kernel_args(x, leaves, sels, 4, **kw)
    with pytest.raises(ValueError, match="CUDA device" if cap is None else
                       f"at most {cap} blocks"):
        cc._kernel_args(x, leaves, sels, 4, backward=True, **kw)


def test_policy_forward_fits_at_any_stack(planned):
    """The policy's K4 holds the whole stack where it fits, else one
    coupling: at the kernels' bounds (d=8, [32,32,32]) and 8 warps a CTA
    one coupling in float64, the rows and the landing slot need 42,048 +
    128 · 36 + 19,232 = 65,888 bytes, so no stack is refused."""
    with _warps(planned, 8):
        need = [cc.mma_plan(d, blocks, depth, _widths(d, depth, hidden))
                for d in (2, 5, 8) for depth in (2, 3, 4)
                for hidden in (8, 16, 32) for blocks in (1, 3, 10, 400)]
        assert cc.mma_plan(8, 400, 4, _widths(8, 4, 32)).bytes == 65888
    assert max(p.bytes for p in need) <= cc.KERNEL_MAX_SMEM


def test_emulated_mma_gives_the_cards_bits(tmp_path):
    """tests/mma_emulation.h's mma16816 through the probe's own source
    (csrc/mma_probe.cu, built with g++ as phase 59 builds it on the card)
    gives the card's bits on every one of phase 59's cases, ±0 alike."""
    cs = _chip_smoke()
    cases = cs.mma_probe_cases()
    lib = cs.build_mma_probe_emulation(tmp_path)
    if lib is None:
        pytest.skip("no g++ to build the host emulation")
    got = cs.mma_probe_emulated(lib, cs.mma_probe_arrays(cases))
    card = _card_bits().view(np.float32)
    assert len(got) == len(card) == len(cases) == 402
    off = [i for i in range(len(cases)) if float(got[i]) != float(card[i])]
    assert not off, [(i, cases[i][0], float(got[i]), float(card[i]))
                     for i in off[:5]]


def test_measured_model_is_the_one_that_fits_the_cards_bits():
    """Of phase 59's models of the sum, exactly one gives the card's bits
    on every case (`fit_tc_models`): 16 products, 2 bits below float32's
    24 kept, cut toward zero, c aligned with the products, a product's
    exponent its operands' sum, the sum normalised toward zero; the old
    model (the exact sum truncated once) misses most families."""
    cs = _chip_smoke()
    cases = cs.mma_probe_cases()
    card = _card_bits().view(np.float32)
    fits, closest = cs.fit_tc_models(cases, card)
    assert fits == [CARD_MODEL] and closest is None
    exact_rz = dict(CARD_MODEL, extra=40, exps="true")
    off = sum(cs.tc_sum(a, b, c, exact_rz) != float(v)
              for (_, a, b, c), v in zip(cases, card))
    assert off > 100


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_policy_kernels_stand_within_the_witness_gate(
        emu, shape, inverse, seed):
    """y, ld, gx and every weight gradient at 40 rows within phase 47's
    gate of the float64-summed witness (`chip_smoke.witness_gate`), and
    each faulty control past it."""
    cs = _chip_smoke()
    stack = _stack(shape)
    fb, sels = stack[0], stack[1]
    x, gy, gld = _inputs(SHAPES[shape][0], 40, seed)
    y, ld, gx, grads = _run(emu, stack, x, gy, gld, inverse, 2)
    mine, controls = cs.witness_errors(cc, fb, x, gy, gld, sels, inverse, BF,
                                       [y, ld, gx, *grads])
    for name, err, err_w in mine:
        assert cs.witness_gate(err, err_w), (name, err, err_w)
    for label, errs in controls.items():
        assert not all(cs.witness_gate(e, ew) for e, ew in errs), label


@pytest.mark.parametrize("k16", [True, False])
def test_emulated_dmma_gives_the_cards_bits(tmp_path, k16):
    """tests/mma_emulation.h's dmma16816 (k16) and four dmma1684 through the
    probe's own source (csrc/mma_probe.cu, `mma_probe_f64`, built with g++
    as phase 60 builds it on the card) give the card's bits on every one of
    phase 60's cases, ±0 alike."""
    cs = _chip_smoke()
    cases = cs.dmma_probe_cases()
    lib = cs.build_mma_probe_emulation(tmp_path)
    if lib is None:
        pytest.skip("no g++ to build the host emulation")
    got = cs.dmma_probe_emulated(lib, cs.dmma_probe_arrays(cases), k16)
    card = _card_dmma_bits().view(np.float64)
    assert len(got) == len(card) == len(cases) == 384
    off = [i for i in range(len(cases)) if not cs._same_f64(got[i], card[i])]
    assert not off, [(i, cases[i][0], float(got[i]), float(card[i]))
                     for i in off[:5]]


def test_measured_dmma_model_is_the_one_that_fits_the_cards_bits():
    """Of phase 60's models of the float64 sum, exactly one gives the
    card's bits on every case (`fit_dmma_models`): a chain of fused
    multiply-adds from c, k in order, rounded to nearest; every case
    within 53 bits is the exact sum, and the sum rounded once (the 16
    products and c at a time) misses cases past 53 bits."""
    cs = _chip_smoke()
    cases = cs.dmma_probe_cases()
    card = _card_dmma_bits().view(np.float64)
    fits, closest = cs.fit_dmma_models(cases, card)
    assert fits == [CARD_DMMA_MODEL] and closest is None
    fams = cs.dmma_by_family(cases, card)
    assert sum(f["within_53_not_exact"] for f in fams.values()) == 0
    assert fams["within 53"]["exact"] == fams["within 53"]["cases"]
    once = dict(CARD_DMMA_MODEL, group=16)
    assert sum(not cs._same_f64(cs.dmma_sum(a, b, c, once), v)
               for (_, a, b, c), v in zip(cases, card)) > 10


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", ["demo", "h32", "d8"])
def test_emulated_other_design_gives_the_same_bits(emu, emu_other, shape,
                                                   inverse):
    """The widening by integer bit operations (OTHER_DESIGN) gives cvt's
    bits in y, ld, gx and every weight gradient: both widenings are
    exact."""
    stack = _stack(shape)
    x, gy, gld = _inputs(SHAPES[shape][0], 40)
    want = _run(emu, stack, x, gy, gld, inverse, 2)
    with _warps(emu_other, 2):
        got = _entries(emu_other, stack, x, gy, gld, inverse, 2, True)
    for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_h32_rows_keep_their_bits(emu, inverse):
    """At H = 32 (two k16 chunks a layer), a row's y, ld and gx at 1, 2, 4
    and 8 warps a CTA are the bits of 4 warps, and two runs agree in every
    output, the weight gradients too."""
    stack = _stack("h32")
    x, gy, gld = _inputs(2, 150)
    want = _run(emu, stack, x, gy, gld, inverse)
    again = _run(emu, stack, x, gy, gld, inverse)
    for a, b in zip(want[:3] + tuple(want[3]), again[:3] + tuple(again[3])):
        assert torch.equal(a, b)
    for warps in (1, 2, 8):
        got = _run(emu, stack, x, gy, gld, inverse, warps)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), warps


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_one_slot_h32_gives_the_resident_bits(planned,
                                                              inverse):
    """At H = 32 under a smaller shared-memory cap (K5 under 100,000 bytes,
    K4 under 60,000) the stack is staged a coupling at a time, and K5's
    partial sums go to device memory: every output keeps its bits, and at
    one warp a CTA (K5's CTAs walking several tiles) y, ld and gx keep
    theirs."""
    emu = planned
    stack = _stack("h32")
    widths = stack[3][0]
    x, gy, gld = _inputs(2, 100)
    want = _run(emu, stack, x, gy, gld, inverse)
    whole = (cc.mma_plan(2, 2, 3, list(widths), True).bytes,
             cc.mma_plan(2, 2, 3, list(widths)).bytes)
    try:
        emu.emu_set_cap(100000)
        one = cc.mma_plan(2, 2, 3, list(widths), True).bytes
        got = _run(emu, stack, x, gy, gld, inverse)
        walked = _run(emu, stack, x, gy, gld, inverse, 1)
        emu.emu_set_cap(60000)
        one_k4 = cc.mma_plan(2, 2, 3, list(widths)).bytes
        y, ld = _run(emu, stack, x, gy, gld, inverse, k5=False)
    finally:
        emu.emu_set_cap(227 * 1024)
    assert one < 100000 < whole[0] and one_k4 < 60000 < whole[1]
    for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        assert torch.equal(a, b)
    for a, b in zip(walked[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(y, want[0]) and torch.equal(ld, want[1])
