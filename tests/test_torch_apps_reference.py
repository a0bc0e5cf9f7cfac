"""The port's scalar reference tracers (``repro_torch.apps.reference``).

* Their eDAGs are byte for byte the JAX package's reference tracers'
  (``repro.apps.reference``): vertex count, memory flags, byte counts and
  edge sets, with and without a cache model, under register pressure and
  false-dependency tracking.
* They are the oracle of the port's block-emission tracers, on every case
  of ``tests/test_vector_engine.py``'s block-port tests.
"""
import numpy as np
import pytest

from repro.apps import reference as jref
from repro.core import make_cache as jmake_cache
from repro_torch.apps import hpcg, lulesh, polybench, reference
from repro_torch.core import Tracer, make_cache


def _graph_sig(g):
    g._finalize()
    return (g.n_vertices, g.is_mem.tobytes(), g.nbytes.tobytes(),
            sorted(zip(g.src.tolist(), g.dst.tolist())))


def test_the_kernels_are_the_references():
    assert sorted(reference.REF_POLYBENCH_KERNELS) == \
        sorted(jref.REF_POLYBENCH_KERNELS)
    assert set(polybench.SCALAR_KERNELS) <= set(reference.REF_POLYBENCH_KERNELS)


# ------------------------------------- byte for byte the JAX package's

@pytest.mark.parametrize("name", sorted(jref.REF_POLYBENCH_KERNELS))
@pytest.mark.parametrize("mode", [{}, {"max_regs": 4},
                                  {"false_deps": True}],
                         ids=["ideal", "regs4", "false_deps"])
def test_polybench_reference_is_the_references(name, mode):
    for cache_size in (0, 1024):
        got = reference.trace_kernel_ref(name, 6, cache=make_cache(cache_size),
                                         **mode)
        want = jref.trace_kernel_ref(name, 6, cache=jmake_cache(cache_size),
                                     **mode)
        assert _graph_sig(got) == _graph_sig(want), (name, mode)


def test_hpcg_reference_is_the_references():
    for cache_size in (0, 32 * 1024):
        g, res = reference.trace_cg_ref(n=4, iters=3,
                                        cache=make_cache(cache_size))
        jg, jres = jref.trace_cg_ref(n=4, iters=3,
                                     cache=jmake_cache(cache_size))
        assert _graph_sig(g) == _graph_sig(jg)
        assert res == jres


def test_lulesh_reference_is_the_references():
    for cache_size in (0, 32 * 1024):
        g = reference.trace_step_ref(ne=3, iters=2,
                                     cache=make_cache(cache_size))
        jg = jref.trace_step_ref(ne=3, iters=2, cache=jmake_cache(cache_size))
        assert _graph_sig(g) == _graph_sig(jg)


# ------------------- the oracle of the port's block-emission tracers
# (tests/test_vector_engine.py:174-240, through the port)

@pytest.mark.parametrize("name", sorted(polybench.SCALAR_KERNELS))
def test_polybench_block_port_exact(name):
    for cache_size in (0, 1024):
        g_blk = polybench.trace_kernel(name, 6, cache=make_cache(cache_size))
        tr = Tracer(cache=make_cache(cache_size))
        reference.REF_POLYBENCH_KERNELS[name](tr, 6, np.random.default_rng(0))
        assert _graph_sig(g_blk) == _graph_sig(tr.edag), name


def test_hpcg_block_port_exact():
    for cache_size in (0, 32 * 1024):
        g_blk, res_blk = hpcg.trace_cg(n=4, iters=3,
                                       cache=make_cache(cache_size))
        g_ref, res_ref = reference.trace_cg_ref(n=4, iters=3,
                                               cache=make_cache(cache_size))
        assert _graph_sig(g_blk) == _graph_sig(g_ref)
        assert np.allclose(res_blk, res_ref, rtol=1e-8)


def test_lulesh_block_port_exact():
    for cache_size in (0, 32 * 1024):
        g_blk = lulesh.trace_step(ne=3, iters=2, cache=make_cache(cache_size))
        g_ref = reference.trace_step_ref(ne=3, iters=2,
                                        cache=make_cache(cache_size))
        assert _graph_sig(g_blk) == _graph_sig(g_ref)


@pytest.mark.parametrize("name", ["trmm", "gemm", "2mm", "lu", "durbin"])
@pytest.mark.parametrize("max_regs", [4, 8])
def test_block_port_exact_under_register_pressure(name, max_regs):
    for cache_size in (0, 1024):
        g_blk = polybench.trace_kernel(name, 6, cache=make_cache(cache_size),
                                       max_regs=max_regs)
        tr = Tracer(cache=make_cache(cache_size), max_regs=max_regs)
        reference.REF_POLYBENCH_KERNELS[name](tr, 6, np.random.default_rng(0))
        assert _graph_sig(g_blk) == _graph_sig(tr.edag), (name, max_regs)


@pytest.mark.parametrize("name", ["gemm", "syr2k", "trmm_spill"])
def test_block_port_exact_false_deps(name):
    for cache_size in (0, 1024):
        g_blk = polybench.trace_kernel(name, 6, cache=make_cache(cache_size),
                                       false_deps=True)
        tr = Tracer(cache=make_cache(cache_size), false_deps=True)
        reference.REF_POLYBENCH_KERNELS[name](tr, 6, np.random.default_rng(0))
        assert _graph_sig(g_blk) == _graph_sig(tr.edag), name
