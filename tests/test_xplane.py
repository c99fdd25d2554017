"""scripts/xplane.py attributes kernels to named scopes via the HLO."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import xplane  # noqa: E402


def test_layer_of_picks_the_most_specific_scope():
    op = "jit(step)/transpose(jvp(field))/cp_level/dot_general"
    assert xplane.layer_of(op) == "cp_level"
    assert xplane.layer_of("jit(step)/jvp(field)/mul") == "field"
    assert xplane.layer_of("jit(step)/jvp(fieldx)/mul") == "other"


def test_parse_hlo_maps_instructions_to_layer_and_direction():
    def loss(w, x):
        with jax.named_scope("field"):
            with jax.named_scope("cp_level"):
                h = jnp.dot(x, w)
            h = jnp.sin(h)
        with jax.named_scope("composite"):
            return jnp.sum(jnp.cumsum(h, axis=1))

    text = (
        jax.jit(jax.grad(loss))
        .lower(jnp.ones((8, 8)), jnp.ones((16, 8)))
        .compile()
        .as_text()
    )
    layers = set(xplane.parse_hlo(text).values())
    assert ("cp_level", False) in layers or ("field", False) in layers
    assert any(bwd for _, bwd in layers)  # transpose(...) ops are backward
    assert {layer for layer, _ in layers} <= set(xplane.LAYERS) | {"other"}
