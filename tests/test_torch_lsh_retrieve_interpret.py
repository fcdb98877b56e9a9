"""Port vs the JAX package's Pallas `lsh_retrieve` kernel in interpret mode,
without an index tail (`test_torch_lsh_retrieve_interpret_tail.py` holds
the cases with one).

Kept apart from `test_torch_serve_kernels.py` because an interpret-mode
launch compiles for ~3 s per shape: over the JAX package's whole sweep
(`tests/test_lsh_retrieve.py`: geometries × exclusion sets) the port's
output must equal the Pallas kernel's bit for bit, and a CPU tensor must
launch no kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lsh_retrieve.kernel import lsh_retrieve_topc as jlsh_kernel
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from test_torch_serve_kernels import (EXCLUDES, GEOMETRIES, SENTINEL,  # noqa: F401
                                      _lsh_inputs, indexed)


def check_against_interpret(indexed, n_seeds, cap, C, excl, *, tail):
    jsp, jidx, jidx_t, *_ = indexed
    ops = _lsh_inputs(jsp, jidx_t if tail else jidx, B=12, n_seeds=n_seeds,
                      cap=cap, tail=tail)
    exclude = np.asarray(list(excl) or [SENTINEL], np.int32)
    want = jlsh_kernel(*map(jnp.asarray, ops), jnp.asarray(exclude), C=C,
                       cap=cap, interpret=True)
    before = lsh_kernel.LAUNCHES
    got = lsh_kernel.lsh_retrieve_topc(*map(torch.tensor, ops),
                                       torch.tensor(exclude), C=C, cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lsh_kernel.LAUNCHES == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("n_seeds,cap,C", GEOMETRIES)
@pytest.mark.parametrize("excl", EXCLUDES)
def test_lsh_retrieve_matches_jax_pallas_interpret(indexed, n_seeds, cap, C,
                                                   excl):
    check_against_interpret(indexed, n_seeds, cap, C, excl, tail=False)
