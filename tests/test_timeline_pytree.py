"""Timeline containers are plain JAX pytrees (``register_dataclass``): the
tick period is static metadata, every array is a leaf, and ``replace``
returns a modified copy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarc_navigation_tpu.ops.timeline import Channel, Timeline, build_timeline


def _tl(freq=10.0):
    ticks = np.arange(5) / freq
    return build_timeline(0.0, 0.4, freq, channels={"odom": (ticks, np.ones((5, 3)))},
                          events={"mbes": (ticks[:2], np.ones((2, 3)), np.arange(2), 2)})


def test_dt_is_static_metadata():
    a, b = _tl(10.0), _tl(20.0)
    assert a.dt == pytest.approx(0.1)
    leaves = jax.tree_util.tree_leaves(a)
    assert all(isinstance(x, np.ndarray) for x in leaves)
    assert jax.tree_util.tree_structure(a) != jax.tree_util.tree_structure(b)
    # retracing keys on dt, and dt reaches the traced function as a float
    seen = []
    f = jax.jit(lambda t: (seen.append(t.dt), t.ticks * 2)[1])
    f(a), f(a), f(b)
    assert seen == [a.dt, b.dt]


def test_replace_and_tree_map():
    tl = _tl()
    od = tl.channels["odom"]
    tl2 = tl.replace(channels={**tl.channels, "odom": od.replace(value=od.value * 3)})
    assert isinstance(tl2, Timeline) and isinstance(tl2.channels["odom"], Channel)
    np.testing.assert_array_equal(tl2.channels["odom"].value, od.value * 3)
    np.testing.assert_array_equal(tl.channels["odom"].value, od.value)  # frozen copy
    doubled = jax.tree_util.tree_map(lambda x: x * 2, tl)
    assert doubled.dt == tl.dt
    np.testing.assert_array_equal(doubled.ticks, tl.ticks * 2)


def test_vmap_and_scan_over_timelines():
    tls = jax.tree_util.tree_map(lambda *xs: np.stack(xs), _tl(), _tl())
    per_tick = jax.vmap(lambda t: jax.lax.scan(
        lambda c, k: (c + jnp.sum(k.channels["odom"].value), None), 0.0, t)[0])(tls)
    np.testing.assert_allclose(np.asarray(per_tick), [15.0, 15.0])


def test_batch_timelines_checks_every_timeline():
    """A list mixing host (numpy) and device timelines stacks on device
    instead of trusting the first timeline's leaf type."""
    from smarc_navigation_tpu.parallel import fleet

    host = _tl()
    dev = jax.tree_util.tree_map(jnp.asarray, _tl())
    for tls in ([host, dev], [dev, host], [host, host]):
        b = fleet.batch_timelines(tls)
        assert b.ticks.shape == (2, 5)
        np.testing.assert_array_equal(np.asarray(b.channels["odom"].value[1]),
                                      np.ones((5, 3)))
