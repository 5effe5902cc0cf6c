"""The C interface of ``nnet_asr_torch/csrc/`` and the profiler grouping of
its kernels, on the CPU.

ctypes passes what ``_build.SIGNATURES`` declares, whatever the C function
takes: a pointer declared as an int is cut to 32 bits, and only the card
would show it. So every ``extern "C"`` declaration in ``csrc/*.cu`` is
parsed here and held to its entry: the same argument count, and a pointer,
an int or a float in each place. ``chip_smoke.py`` sums the device time of
a production step by kernel name (``KERNEL_GROUPS``, first match wins); the
kernels' demangled names, as the profiler reports them, must land in their
own group, and cuBLAS's in "cuBLAS GEMM".
"""

import ctypes
import glob
import os
import re
import sys

import pytest

from nnet_asr_torch.ops.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
# the one entry point outside SIGNATURES: its types are set by load_library
OTHER = {"nnet_cuda_error_string": ("const char*", ["int"])}


def _declarations():
    """{name: (return type, [argument kinds])} of every extern "C" function."""
    decls = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for ret, name, args in re.findall(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)',
                                          src):
            kinds = []
            for arg in (a.strip() for a in args.split(",") if a.strip()):
                if "*" in arg:
                    kinds.append("pointer")
                else:
                    kinds.append(arg.split()[-2])
            decls[name] = (" ".join(ret.split()), kinds)
    return decls


def test_every_extern_c_function_is_declared_to_ctypes():
    decls = _declarations()
    assert sorted(decls) == sorted([*_build.SIGNATURES, *OTHER])


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_extern_c_signature_matches_ctypes(name):
    ret, kinds = _declarations()[name]
    assert ret == "int"                  # the cudaError_t code the wrappers check
    assert kinds == [KINDS[t] for t in _build.SIGNATURES[name]]


def test_error_string_signature():
    assert _declarations()["nnet_cuda_error_string"] == OTHER["nnet_cuda_error_string"]


sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the standard library only at its top level)

# demangled kernel names as the profiler reports them -> group
KERNEL_NAMES = {
    "(anonymous namespace)::matmul_act_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, __nv_bfloat16 const*, int, int, int)": "affine_sigmoid bf16 (ours)",
    "void (anonymous namespace)::wgrad_momentum_wgmma_kernel<float>(CUtensorMap_st, "
    "CUtensorMap_st, float*, float*, float, float, int, int, int)":
        "wgrad_momentum_update bf16 (ours)",
    "void (anonymous namespace)::wgrad_momentum_wgmma_kernel<__nv_bfloat16>(CUtensorMap_st, "
    "CUtensorMap_st, float*, __nv_bfloat16*, float, float, int, int, int)":
        "wgrad_momentum_update bf16 (ours)",
    "(anonymous namespace)::matmul_act_f32_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float const*, float*, int, int, int, int)": "affine_sigmoid f32 WGMMA (ours)",
    "(anonymous namespace)::matmul_act_f32_split_kernel(float4 const*, uint4*, uint4*, "
    "unsigned long)": "affine_sigmoid f32 WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_f32_wgmma_kernel<float>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, float*, float*, float, float, int, int, int)":
        "wgrad_momentum_update f32 WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_f32_wgmma_kernel<__nv_bfloat16>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, float*, __nv_bfloat16*, float, float, int, int, int)":
        "wgrad_momentum_update f32 WGMMA (ours)",
    "(anonymous namespace)::wgrad_momentum_f32_split_kernel(float const*, float*, float*, int, "
    "int)": "wgrad_momentum_update f32 WGMMA (ours)",
    "void (anonymous namespace)::matmul_act_kernel<nnet_tile::Tile<128, 128, 32, 2, 4, 3>, "
    "__nv_bfloat16>(__nv_bfloat16 const*)": "affine_sigmoid bf16 (ours)",
    "void (anonymous namespace)::matmul_act_f32_cp_wgmma_kernel<nnet_cpf::CpF32Tile<2, 64, 4, 0> "
    ">(float const*, float const*, float const*, float*, float*, int*, int, int, int, int, int, "
    "int, int)": "affine_sigmoid f32 CP_WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_f32_cp_wgmma_kernel<nnet_cpf::CpF32Tile<2, 64, 4, "
    "1>, float>(float const*, float const*, float*, float*, float*, int*, float, float, int, int, "
    "int, int, int, int)": "wgrad_momentum_update f32 CP_WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_f32_cp_wgmma_kernel<nnet_cpf::CpF32Tile<2, 64, 4, "
    "1>, __nv_bfloat16>(float const*, float const*, float*, __nv_bfloat16*, float*, int*, float, "
    "float, int, int, int, int, int, int)": "wgrad_momentum_update f32 CP_WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_f32_ws_wgmma_kernel<nnet_cpf::WsF32Tile<136, 4>, "
    "float>(float const*, float const*, float*, float*, float, float, int, int, int, int, int, "
    "int)": "wgrad_momentum_update f32 WS_WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_bf16_cp_wgmma_kernel<nnet_cpw::CpWgradTile<64, 3>, "
    "float>(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, float*, float, float, int, int, "
    "int, int, int, int)": "wgrad_momentum_update bf16 CP_WGMMA (ours)",
    "void (anonymous namespace)::wgrad_momentum_bf16_cp_wgmma_kernel<nnet_cpw::CpWgradTile<136, "
    "4>, __nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, __nv_bfloat16*, "
    "float, float, int, int, int, int, int, int)":
        "wgrad_momentum_update bf16 CP_WGMMA (ours)",
    "void (anonymous namespace)::matmul_act_cp_wgmma_kernel<nnet_cpw::CpTile<1, 64, 3> >("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, "
    "int*, int, int, int, int, int, int, int)": "affine_sigmoid bf16 (ours)",
    "void (anonymous namespace)::matmul_act_kernel<nnet_tile::Tile<128, 128, 32, 2, 4, 3>, "
    "float>(float const*)": "affine_sigmoid (ours)",
    "void (anonymous namespace)::wgrad_momentum_kernel<nnet_tile::Tile<64, 64, 32, 2, 2, 4, true>, "
    "__nv_bfloat16, float>(__nv_bfloat16 const*)": "wgrad_momentum_update bf16 (ours)",
    "void (anonymous namespace)::wgrad_momentum_kernel<nnet_tile::Tile<128, 128, 32, 2, 4, 3>, "
    "float, float>(float const*)": "wgrad_momentum_update (ours)",
    "void (anonymous namespace)::matmul_act_kernel<nnet_tile::Tile<64, 64, 32, 2, 4, 4, true>, "
    "float>(float const*)": "affine_sigmoid (ours)",
    "void (anonymous namespace)::matmul_act_kernel<nnet_tile::Tile<64, 64, 32, 2, 2, 4, true>, "
    "__nv_bfloat16>(__nv_bfloat16 const*)": "affine_sigmoid bf16 (ours)",
    "void (anonymous namespace)::wgrad_momentum_kernel<nnet_tile::Tile<64, 64, 32, 2, 2, 4, true>, "
    "float, __nv_bfloat16>(float const*)": "wgrad_momentum_update (ours)",
    "void (anonymous namespace)::softmax_xent_rows<16, 4, false>((anonymous namespace)::Args)":
        "softmax_xent (ours)",
    "(anonymous namespace)::dgrad_f32_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float*, int, int, int)": "dgrad f32 WGMMA (ours)",
    "(anonymous namespace)::dgrad_f32_split_kernel(float4 const*, uint4*, uint4*, "
    "unsigned long)": "dgrad f32 WGMMA (ours)",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": "cuBLAS GEMM",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3": "cuBLAS GEMM",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(Params)": "cuBLAS GEMM",
}


@pytest.mark.parametrize("key", sorted(KERNEL_NAMES))
def test_profiler_groups_attribute_each_kernel(key):
    group = next((g for g, pat in chip_smoke.KERNEL_GROUPS if re.search(pat, key)), "other")
    assert group == KERNEL_NAMES[key]


# The dgrad's kernels through the benchmark's groups (benchmark/trace.py):
# none takes them, so neither the forward's roofline (every name holding
# "matmul_act") nor cuBLAS's group counts their time
DGRAD_KERNELS = [k for k, g in KERNEL_NAMES.items() if g == "dgrad f32 WGMMA (ours)"]


@pytest.mark.parametrize("name", DGRAD_KERNELS)
def test_benchmark_trace_groups_none_of_the_dgrad_kernels(name):
    from benchmark import trace

    assert trace.group_of(name) == name[:80]
    assert "matmul_act" not in name and "wgrad_momentum" not in name


# ptxas's report of WGMMA-route kernels (bf16 and f32; the f32 route's
# pre-pass is no wgmma kernel): the spill bytes chip_smoke reads per kernel
def test_wgmma_spills_from_ptxas_report():
    log = ("ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_wgmma_kernel"
           "E14CUtensorMap_st' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_kernel' for "
           "'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN45_wgrad_momentum_wgmma_kernelIfEEv' for "
           "'sm_90a'\n"
           "    0 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_f32_split_kernel"
           "EPK6float4' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_f32_wgmma_kernel"
           "E14CUtensorMap_st' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN49_wgrad_momentum_f32_wgmma_kernelI13__nv_"
           "bfloat16EEv' for 'sm_90a'\n"
           "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_cp_wgmma_kernel"
           "IN8nnet_cpw6CpTileILi1ELi64ELi3EEEEEvPK13__nv_bfloat16' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__x_matmul_act_f32_cp_wgmma_"
           "kernelIN8nnet_cpf9CpF32TileILi2ELi64ELi4ELi0EEEEEvPKf' for 'sm_90a'\n"
           "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__x_wgrad_momentum_bf16_cp_"
           "wgmma_kernelIN8nnet_cpw11CpWgradTileILi136ELi4EEEfEEvPK13__nv_bfloat16' for "
           "'sm_90a'\n"
           "    392 bytes stack frame, 400 bytes spill stores, 488 bytes spill loads\n")
    assert chip_smoke.wgmma_spills(log) == {
        "_ZN46_GLOBAL__N__x_matmul_act_wgmma_kernelE14CUtensorMap_st": 0,
        "_ZN45_wgrad_momentum_wgmma_kernelIfEEv": 16,
        "_ZN46_GLOBAL__N__x_matmul_act_f32_wgmma_kernelE14CUtensorMap_st": 0,
        "_ZN49_wgrad_momentum_f32_wgmma_kernelI13__nv_bfloat16EEv": 16,
        "_ZN46_GLOBAL__N__x_matmul_act_cp_wgmma_kernelIN8nnet_cpw6CpTileILi1ELi64ELi3EEEEEvPK13__"
        "nv_bfloat16": 0,
        "_ZN46_GLOBAL__N__x_matmul_act_f32_cp_wgmma_kernelIN8nnet_cpf9CpF32TileILi2ELi64ELi4ELi0EE"
        "EEEvPKf": 8,
        "_ZN45_GLOBAL__N__x_wgrad_momentum_bf16_cp_wgmma_kernelIN8nnet_cpw11CpWgradTileILi136ELi4"
        "EEEfEEvPK13__nv_bfloat16": 888}
    # 3 bf16 TMA instances, 3 f32 ones, the bf16 CP_WGMMA forward and its
    # wgrad on both tiles at f32 and bf16 velocity, the f32 CP_WGMMA forward
    # and its wgrad at f32 and bf16 velocity, the f32 WS_WGMMA wgrad at both,
    # the f32 dgrad
    assert chip_smoke.WGMMA_KERNELS == 17
