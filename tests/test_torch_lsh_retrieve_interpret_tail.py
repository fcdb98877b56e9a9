"""Port vs the JAX package's Pallas `lsh_retrieve` kernel in interpret mode,
with five cloned items resident in the index tail (the `extra` operand
holds real tail hits).  The same sweep as
`test_torch_lsh_retrieve_interpret.py`, in a file of its own so that
each file's interpret-mode compiles stay within a minute."""
import pytest

from test_torch_lsh_retrieve_interpret import check_against_interpret
from test_torch_serve_kernels import EXCLUDES, GEOMETRIES, indexed  # noqa: F401


@pytest.mark.parametrize("n_seeds,cap,C", GEOMETRIES)
@pytest.mark.parametrize("excl", EXCLUDES)
def test_lsh_retrieve_with_tail_matches_jax_pallas_interpret(
        indexed, n_seeds, cap, C, excl):
    check_against_interpret(indexed, n_seeds, cap, C, excl, tail=True)
