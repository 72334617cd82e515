"""PyTorch port: the build comparison's parsing of nvcc and cuobjdump output (CPU).

``runtime/compare_builds.py`` decides from an ``-Xptxas -v`` log and a
``cuobjdump -sass`` dump whether two builds compile a kernel alike; the
samples below are in the format the CUDA 12 toolkit prints.
"""
import pytest

pytest.importorskip("torch")

from mcmc_spec_tpu_torch.runtime import compare_builds as cb  # noqa: E402

LOG = """\
nvcc -gencode arch=compute_90a,code=sm_90a -c -o k.o log_posterior_fused.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN9mcmc_spec2k1Ev' for 'sm_90a'
ptxas info    : Function properties for _ZN9mcmc_spec2k1Ev
    48 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 48 bytes cumulative stack size, 592 bytes smem
ptxas info    : Compiling entry function '_ZN9mcmc_spec2k3Ev' for 'sm_90a'
ptxas info    : Used 32 registers, used 1 barriers, 192 bytes smem
"""

DUMP = """\
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN9mcmc_spec2k3Ev
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                      /* 0x000000000000794d */
                                                               /* 0x000fea0003800000 */
\t\t..........

\t\tFunction : _ZN9mcmc_spec2k1Ev
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                        /* 0x000000000000794d */
                                                                 /* 0x000fea0003800000 */
\t\tFunction : _ZN9mcmc_spec2k5Ev
        /*10000*/                  NOP ;                       /* 0x0000000000007918 */
"""


def test_ptxas_lines():
    assert cb.ptxas_lines(LOG) == {
        "_ZN9mcmc_spec2k1Ev": "Used 40 registers, used 1 barriers, 48 bytes cumulative stack size, "
                              "592 bytes smem",
        "_ZN9mcmc_spec2k3Ev": "Used 32 registers, used 1 barriers, 192 bytes smem",
    }


def test_sass_drops_addresses_and_groups_identical_kernels():
    s = cb.sass(DUMP)
    assert s["_ZN9mcmc_spec2k3Ev"] == [
        "LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */", "/* 0x000fe40000000800 */",
        "EXIT ; /* 0x000000000000794d */", "/* 0x000fea0003800000 */"]
    assert s["_ZN9mcmc_spec2k5Ev"] == ["NOP ; /* 0x0000000000007918 */"]
    assert cb.same_sass_groups(s) == [["_ZN9mcmc_spec2k1Ev", "_ZN9mcmc_spec2k3Ev"]]


def test_compare_flags_changed_and_missing_kernels():
    p, s = cb.ptxas_lines(LOG), cb.sass(DUMP)
    other = (p, s)
    changed = (dict(p, _ZN9mcmc_spec2k3Ev="Used 33 registers"),
               dict(s, _ZN9mcmc_spec2k1Ev=s["_ZN9mcmc_spec2k1Ev"][:2]))
    assert cb.compare(other, other) == [("_ZN9mcmc_spec2k1Ev", True, True),
                                        ("_ZN9mcmc_spec2k3Ev", True, True)]
    assert cb.compare(other, changed) == [("_ZN9mcmc_spec2k1Ev", True, False),
                                          ("_ZN9mcmc_spec2k3Ev", False, True)]
    assert cb.compare(other, ({}, {})) == [("_ZN9mcmc_spec2k1Ev", False, False),
                                           ("_ZN9mcmc_spec2k3Ev", False, False)]


def test_main_wants_one_checkout(capsys):
    assert cb.main([]) == 2
    assert "compare_builds <other checkout>" in capsys.readouterr().err


def test_kernel_with_new_parameters_is_held_against_its_counterpart():
    """A kernel whose parameters changed keeps its qualified name: the comparison finds it."""
    name = ("_ZN9mcmc_spec26log_posterior_fused_kernelEPKfS1_NS_15PosteriorTablesENS_"
            "15PosteriorConfigEfPf")
    assert cb.base_name(name) == "mcmc_spec::log_posterior_fused_kernel"
    assert cb.base_name("_ZN9mcmc_spec25posterior_sections_kernelILb0EEEvPKf") == \
        "mcmc_spec::posterior_sections_kernel"
    assert cb.base_name("trivial") == "trivial"
    p, s = cb.ptxas_lines(LOG), cb.sass(DUMP)
    moved = {k + "i": v for k, v in p.items()}
    assert cb.counterpart("_ZN9mcmc_spec2k1Ev", moved) == "_ZN9mcmc_spec2k1Evi"
    assert cb.counterpart("_ZN9mcmc_spec2k9Ev", moved) == "_ZN9mcmc_spec2k9Ev"
    this = (moved, {k + "i": v for k, v in s.items()})
    assert cb.compare((p, s), this) == [("_ZN9mcmc_spec2k1Ev", True, True),
                                        ("_ZN9mcmc_spec2k3Ev", True, True)]
