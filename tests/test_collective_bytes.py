"""Pin the compiled-HLO collective-byte extraction that bounds the
communication term of the multi-device programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from hyperres.parallel.introspect import (
    collective_bytes, collective_bytes_from_text,
)


def test_extraction_from_known_hlo_text():
    txt = """
  ar = f32[64,32]{1,0} all-reduce(x), replica_groups={}
  cp = bf16[8,16]{1,0} collective-permute(y), source_target_pairs={{0,1}}
  plain = f32[4,4]{1,0} add(a, b)
"""
    total, counts = collective_bytes_from_text(txt)
    assert counts == {"all-reduce": 1, "collective-permute": 1}
    assert total == 64 * 32 * 4 + 8 * 16 * 2


def test_extraction_on_compiled_shard_map():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = Mesh(np.array(devs[:8]), ("d",))
    n, k = 64, 16

    @jax.jit
    def prog(x):
        def body(xs):
            # one all-reduce (psum) + one collective-permute (ppermute)
            s = jax.lax.psum(jnp.sum(xs, axis=0), "d")
            nb = jax.lax.ppermute(
                xs, "d", [(i, (i + 1) % 8) for i in range(8)])
            return nb + s[None, :]

        return jax.shard_map(body, mesh=mesh, in_specs=P("d", None),
                             out_specs=P("d", None))(x)

    total, counts = collective_bytes(
        prog, jax.ShapeDtypeStruct((n, k), jnp.float32))
    assert counts.get("all-reduce", 0) >= 1
    assert counts.get("collective-permute", 0) >= 1
    # the permute moves at least each shard's block once
    assert total >= n * k * 4 / 8
    # and extraction agrees with running the real thing
    x = jnp.arange(n * k, dtype=jnp.float32).reshape(n, k)
    out = prog(x)
    assert out.shape == (n, k)
