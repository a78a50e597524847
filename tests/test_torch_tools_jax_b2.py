"""ablate_pt's b2 variant (two bounces) against the JAX package's
render_frame at two bounces: the harness and bars of
tests/test_torch_tools_jax.py, in a file of its own so that its JAX
compile (≈ 80 s cold) runs beside the others."""
from test_torch_tools_jax import variant_matches_jax


def test_ablate_b2_matches_jax():
    variant_matches_jax("b2")
