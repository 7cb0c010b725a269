"""Port of the pairwise-MLP affinity op against the JAX package.

The port's plain version (`graphecho_torch.ops.pairwise_mlp.pairwise_mlp`)
and its backward formulas run here on the CPU against the JAX XLA path
(`graphecho_tpu.ops.pairwise_mlp.pairwise_mlp`) and the Pallas kernel in
interpret mode, on the same numpy inputs. The CUDA kernels themselves run
only on a GPU: `tests/test_torch_pairwise_mlp_card.py` holds them to the
plain version there and skips elsewhere; `chip_smoke.py` does the same at the
paper's shapes.

Tolerances: forward atol 1e-4, gradients rtol/atol 1e-3, those of the JAX
package's own interpret-vs-XLA test (`tests/test_graph_matching.py:487,495`).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.ops.pairwise_mlp import pairwise_mlp as jax_pairwise_mlp
from graphecho_tpu.ops.pallas.pairwise_mlp_kernel import pallas_pairwise_mlp

from graphecho_torch import pairwise_bench
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.profile_step import PAIRWISE_KERNELS, kernel_base_name


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [(70, 50, 40), (112, 112, 128)]


def report_parity(what, got, want):
    """One line for the parity table in PERF.md (`pytest -s ... | grep PARITY`)."""
    err = np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    print(f"PARITY {what} max_abs_err={err:.3g}")


def _inputs(n1, n2, k, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(n1, k).astype(np.float32), rng.randn(n2, k).astype(np.float32),
            rng.randn(k).astype(np.float32), np.float32(0.2),
            rng.randn(n1, n2).astype(np.float32))


@pytest.mark.parametrize("n1,n2,k", SHAPES)
def test_plain_forward_matches_jax_and_pallas_interpret(n1, n2, k):
    a, b, w2, b2, _ = _inputs(n1, n2, k)
    got = pm.pairwise_mlp(*(torch.from_numpy(np.asarray(x)) for x in (a, b, w2, b2)))
    want_xla = jax_pairwise_mlp(a, b, w2, b2)
    want_pallas = pallas_pairwise_mlp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w2),
                                      jnp.asarray(b2), True)
    report_parity(f"pairwise_mlp fwd {n1}x{n2}x{k} vs XLA", got.numpy(), want_xla)
    report_parity(f"pairwise_mlp fwd {n1}x{n2}x{k} vs Pallas interpret", got.numpy(), want_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=1e-4)


def _nan_inputs(n1=70, n2=50, k=40):
    """`_inputs` with NaN at a[5, 7] and b[n2 - 3, 11]."""
    a, b, w2, b2, g = _inputs(n1, n2, k, seed=3)
    a[5, 7] = np.nan
    b[n2 - 3, 11] = np.nan
    return a, b, w2, b2, g


def test_plain_forward_keeps_nan_as_jax_and_pallas_interpret_do():
    """A NaN in a[i, k] or b[j, k] makes row i or column j of the output NaN in
    the XLA path (`jnp.maximum`), the Pallas kernel in interpret mode and the
    port's plain version alike, and nothing else; the CUDA kernel is held to
    the plain version's pattern on the card."""
    a, b, w2, b2, _ = _nan_inputs()
    got = pm.pairwise_mlp(*(torch.from_numpy(np.asarray(x)) for x in (a, b, w2, b2))).numpy()
    want_xla = np.asarray(jax_pairwise_mlp(a, b, w2, b2))
    want_pallas = np.asarray(pallas_pairwise_mlp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w2),
                                                 jnp.asarray(b2), True))
    nan = np.isnan(want_xla)
    assert nan[5].all() and nan[:, 47].all() and nan.sum() == 70 + 50 - 1
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.isnan(want_pallas), nan)
    np.testing.assert_allclose(got[~nan], want_xla[~nan], atol=1e-4)
    np.testing.assert_allclose(got[~nan], want_pallas[~nan], atol=1e-4)


def test_backward_formulas_keep_nan_as_jax_vjp_does():
    """The same NaN input through the backward formulas that the CUDA backward
    is held to on the card (chip_smoke's kernel_nan lines): NaN exactly where
    `jax.vjp` of the XLA path has it (dw2 at columns 7 and 11; dA, dB and db2
    finite, relu's mask being 0 at NaN), equal elsewhere within rtol/atol
    1e-3. Autograd of the plain version is held to the same pattern in
    `test_plain_autograd_keeps_nan_as_jax_vjp_does`."""
    a, b, w2, b2, g = _nan_inputs()
    _, vjp = jax.vjp(jax_pairwise_mlp, *(jnp.asarray(x) for x in (a, b, w2, b2)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    formulas = pm.pairwise_mlp_backward_reference(
        *(torch.from_numpy(x) for x in (a, b, w2)), torch.from_numpy(g))
    assert np.argwhere(np.isnan(want[2])).ravel().tolist() == [7, 11]
    for name, f, w in zip(("dA", "dB", "dw2", "db2"), formulas, want):
        got = f.numpy().reshape(w.shape)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w), err_msg=name)
        ok = ~np.isnan(w)
        np.testing.assert_allclose(got[ok], w[ok], rtol=1e-3, atol=1e-3, err_msg=name)


def test_plain_autograd_keeps_nan_as_jax_vjp_does():
    """Autograd of the plain version (the path of every CPU tensor) on the NaN
    input: dA, dB and dw2 NaN exactly where `jax.vjp` of the XLA path has
    them (its relu's gradient is 0 at NaN, as the port's is), equal elsewhere
    within rtol/atol 1e-3."""
    a, b, w2, b2, g = _nan_inputs()
    _, vjp = jax.vjp(jax_pairwise_mlp, *(jnp.asarray(x) for x in (a, b, w2, b2)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    ta, tb, tw2, tb2 = (torch.tensor(np.asarray(x), requires_grad=True)
                        for x in (a, b, w2, b2))
    pm.pairwise_mlp(ta, tb, tw2, tb2).backward(torch.from_numpy(g))
    for name, got, w in zip(("dA", "dB", "dw2"), (ta.grad, tb.grad, tw2.grad), want):
        got = got.numpy()
        report_parity(f"pairwise_mlp autograd {name} at NaN vs jax.vjp", got[~np.isnan(w)],
                      w[~np.isnan(w)])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w), err_msg=name)
        ok = ~np.isnan(w)
        np.testing.assert_allclose(got[ok], w[ok], rtol=1e-3, atol=1e-3, err_msg=name)


def _integer_inputs(n1, n2, k, seed=5):
    """a, b in [-4, 4] (many a+b exactly 0), w2 in [-2, 2], g in [-3, 3]:
    every sum is an integer below 2^24, so each version computes it exactly."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-4, 5, (n1, k)).astype(np.float32),
            rng.randint(-4, 5, (n2, k)).astype(np.float32),
            rng.randint(-2, 3, k).astype(np.float32), np.float32(1.0),
            rng.randint(-3, 4, (n1, n2)).astype(np.float32))


@pytest.mark.parametrize("n1,n2,k,integer", [(70, 50, 40, False), (112, 112, 128, False),
                                             (70, 50, 40, True)],
                         ids=["70-50-40", "112-112-128", "70-50-40-integer"])
def test_backward_reference_and_autograd_match_jax_grad(n1, n2, k, integer):
    """Random inputs within rtol/atol 1e-3; on integer inputs the formulas,
    autograd of the plain version, `jax.vjp` of the XLA path and of the
    Pallas kernel in interpret mode agree exactly, so the mask at a+b = 0 is
    the same (0) in all of them."""
    a, b, w2, b2, g = _integer_inputs(n1, n2, k) if integer else _inputs(n1, n2, k, seed=3)
    if integer:
        assert ((a[:, None, :] + b[None, :, :]) == 0).any()
    args = [jnp.asarray(x) for x in (a, b, w2, b2)]
    _, vjp = jax.vjp(jax_pairwise_mlp, *args)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    ta, tb, tw2, tb2 = (torch.tensor(np.asarray(x), requires_grad=True)
                        for x in (a, b, w2, b2))
    tg = torch.from_numpy(g)
    formulas = pm.pairwise_mlp_backward_reference(ta.detach(), tb.detach(), tw2.detach(), tg)
    pm.pairwise_mlp(ta, tb, tw2, tb2).backward(tg)
    autograd = (ta.grad, tb.grad, tw2.grad, tb2.grad)
    if integer:
        _, vjp_pallas = jax.vjp(lambda *x: pallas_pairwise_mlp(*x, True), *args)
        pallas = [np.asarray(x) for x in vjp_pallas(jnp.asarray(g))]
    for i, (name, f, ag, w) in enumerate(zip(("dA", "dB", "dw2", "db2"), formulas, autograd,
                                             want)):
        report_parity(f"pairwise_mlp {name} {n1}x{n2}x{k}{' integer' if integer else ''} "
                      "vs jax.vjp", f.numpy(), w)
        if integer:
            np.testing.assert_array_equal(f.numpy(), w, err_msg=name)
            np.testing.assert_array_equal(ag.numpy(), w, err_msg=name)
            np.testing.assert_array_equal(np.asarray(pallas[i]).reshape(w.shape), w,
                                          err_msg=f"{name} Pallas interpret")
        else:
            np.testing.assert_allclose(f.numpy(), w, rtol=1e-3, atol=1e-3, err_msg=name)
            np.testing.assert_allclose(ag.numpy(), w, rtol=1e-3, atol=1e-3, err_msg=name)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    a, b, w2, b2, g = _inputs(70, 50, 40)
    pm.reset_launch_counts()
    ta, tb, tw2, tb2 = (torch.tensor(np.asarray(x), requires_grad=True)
                        for x in (a, b, w2, b2))
    out = pm.pairwise_mlp_auto(ta, tb, tw2, tb2)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_pairwise_mlp(a, b, w2, b2)),
                               atol=1e-4)
    assert ta.grad is not None and tb2.grad is not None
    assert pm.LAUNCHES == {"pairwise_mlp_fwd": 0, "pairwise_mlp_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    a, b, w2, b2, g = (torch.from_numpy(np.asarray(x)) for x in _inputs(8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_fwd(a, b, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_bwd(a, b, w2, g)



# ----------------------------------------------------- the measurement tools
_SOURCE = (Path(__file__).resolve().parent.parent / "graphecho_torch" / "csrc"
           / "pairwise_mlp.cu").read_text()


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::fwd_kernel(float const*, float const*, float const*, "
     "float*, int, int, int)", "fwd_kernel"),
    ("void (anonymous namespace)::pairwise_bwd_kernel(float const*, float const*, "
     "float const*, float*, float*, float*, float*, int, int, int, int, int)",
     "pairwise_bwd_kernel"),
    ("void (anonymous namespace)::pairwise_fwd_kernel<(anonymous namespace)::FwdTile<6, 7, 8, "
     "8, 4, 16, 3, 1> >(float const*, float const*, float const*, float const*, float*, int, "
     "int, int, int)", "pairwise_fwd_kernel"),
    ("void flash_fwd_kernel<Flash_fwd_kernel_traits<128, 64> >(Flash_fwd_params)",
     "flash_fwd_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"),
])
def test_profile_step_reads_kernel_function_names(name, base):
    assert kernel_base_name(name) == base


def test_profile_step_knows_every_pairwise_kernel():
    """`profile_step` counts the pairwise kernels by function name: every
    `__global__` of csrc/pairwise_mlp.cu is in its list, the older forward
    `fwd_kernel` too (so an older tree can be profiled), and no other kernel
    of the port's sources is."""
    names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)", _SOURCE)
    assert set(names) == {"pairwise_fwd_kernel", "pairwise_bwd_kernel", "pairwise_finish_kernel"}
    assert set(names) | {"fwd_kernel"} <= set(PAIRWISE_KERNELS)
    knn = (Path(__file__).resolve().parent.parent / "graphecho_torch" / "csrc"
           / "knn.cu").read_text()
    knn_names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)", knn)
    assert knn_names and not set(knn_names) & set(PAIRWISE_KERNELS)


def test_pairwise_bench_adapts_only_the_older_interface():
    assert pairwise_bench.with_entry_point(_SOURCE) == _SOURCE
    older = "int pairwise_mlp_bwd_da(float* x) {}\nint pairwise_mlp_bwd_db(float* x) {}\n"
    adapted = pairwise_bench.with_entry_point(older)
    assert adapted.startswith(older) and "pairwise_mlp_bwd(" in adapted
    assert "pairwise_mlp_bwd_scratch_floats(" in adapted
    with pytest.raises(ValueError, match="no backward entry point"):
        pairwise_bench.with_entry_point("int pairwise_mlp_fwd(float* x) {}\n")


_OLDER_FWD = ("extern \"C\" {\nint pairwise_mlp_fwd(const float* a, const float* b, "
              "const float* w2, float* out,\n                     int n1, int n2, int k, "
              "void* stream) {\n  return 0;\n}\n}\n")


def test_pairwise_bench_adapts_only_the_older_forward():
    """A forward that takes b2 is timed as it is; one without b2 is renamed and
    called through an adapter with the new signature."""
    assert pairwise_bench.adds_b2(_SOURCE)
    assert pairwise_bench.with_fwd_entry_point(_SOURCE) == _SOURCE
    assert not pairwise_bench.adds_b2(_OLDER_FWD)
    adapted = pairwise_bench.with_fwd_entry_point(_OLDER_FWD)
    assert "int pairwise_mlp_fwd_without_b2(const float* a" in adapted
    assert adapted.endswith(pairwise_bench.FWD_ADAPTER)
    assert re.search(r"int pairwise_mlp_fwd\(const float\* a, const float\* b, const float\* w2,"
                     r"\s*const float\* b2", adapted)
    with pytest.raises(ValueError, match="no forward entry point"):
        pairwise_bench.with_fwd_entry_point("int pairwise_mlp_bwd(float* x) {}\n")


def test_pairwise_bench_forward_variants_edit_only_their_head():
    """Each forward variant is this tree's file behind one #define that the
    source reads."""
    for name, head in pairwise_bench.FWD_VARIANTS.items():
        macro = head.split()[1]
        assert head.startswith("#define ") and head.endswith("\n"), name
        assert re.search(rf"#if(n?def| defined)?\s*\(?{macro}\b", _SOURCE), name


def test_pairwise_bench_ablation_finds_its_edit_point():
    """`no_triples` cuts the (i, j, k) loop by exact text: the kernel's source
    holds it once."""
    assert _SOURCE.count(pairwise_bench.TRIPLES[0]) == 1
