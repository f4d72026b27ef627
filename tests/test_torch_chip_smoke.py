"""``chip_smoke.py``'s reading of nvcc's ``-Xptxas -v`` report, on an
excerpt of the report for ``lcqpow_tpu_torch/csrc/gj_inverse.cu``."""

import pytest

import chip_smoke

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115gj_block_kernelILi48EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115gj_block_kernelILi48EEEvPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 48000 bytes smem
ptxas info    : Compile time = 94.783 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114gj_warp_kernelILi14ELi2EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114gj_warp_kernelILi14ELi2EEEvPKfPfi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 372 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114gj_warp_kernelILi13ELi1EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114gj_warp_kernelILi13ELi1EEEvPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers, 372 bytes cmem[0]
"""


@pytest.mark.parametrize("key,want", [
    (("gj_block_kernel", 48, 0), [127, 0, 0]),
    (("gj_warp_kernel", 14, 2), [48, 4, 12]),
])
def test_ptxas_usage_reads_registers_and_spills(key, want):
    usage = chip_smoke.ptxas_usage(LOG, (14, 48))
    assert usage[key] == want
    assert ("gj_warp_kernel", 13, 1) not in usage
