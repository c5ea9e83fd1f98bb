"""The kernel build's bookkeeping, on the CPU: nvcc runs with ptxas's
report on, so the report's flag is part of the build hash, and
``ptxas_summary`` reads each kernel's registers, shared memory and spills
from nvcc's kept output."""
from se2lam_tpu_torch.kernels import build, ptxas_summary

NVCC_OUTPUT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119schur_reduce_kernelILb1EEEvPKfS2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119schur_reduce_kernelILb1EEEvPKfS2_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120windowed_top2_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120windowed_top2_kernelEv
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 13312 bytes smem, 456 bytes cmem[0]
"""


def test_ptxas_summary_reads_each_kernel():
    got = ptxas_summary(NVCC_OUTPUT)
    assert [k["name"][:28] for k in got] == ["_ZN12_GLOBAL__N_119schur_red",
                                            "_ZN12_GLOBAL__N_120windowed_"]
    assert [(k["registers"], k["smem_bytes"], k["spill_stores"], k["spill_loads"])
            for k in got] == [(96, 0, 0, 0), (90, 13312, 8, 12)]
    assert ptxas_summary("") == []


def test_build_keeps_the_ptxas_report():
    flags = build.NVCC_FLAGS
    assert "-Xptxas" in flags and flags[flags.index("-Xptxas") + 1] == "-v"
    assert {s.stem for s in build._sources()} == {"fast_nms", "schur_reduce", "windowed_top2"}
