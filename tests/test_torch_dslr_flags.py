"""The torch port's DSLR solver with each of its flags (share_weights,
remat, circular_pad off, real layers, fix_step_size) against the JAX
package on converted weights: outputs and every gradient."""

import pytest

from tests.test_torch_dslr import (  # noqa: F401 (the fixture)
    _check_against_jax, dslr_problem,
)


@pytest.mark.parametrize("flags", (
    dict(share_weights=True), dict(remat=True), dict(circular_pad=False),
    dict(use_complex_layers=False), dict(fix_step_size=True)),
    ids=lambda f: next(iter(f)))
def test_solver_flags_match_jax(dslr_problem, flags):  # noqa: F811
    """One mode, modslr-v2 (its lambdas are what fix_step_size freezes)."""
    _check_against_jax(dslr_problem, "modslr-v2", **flags)
