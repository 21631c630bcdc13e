"""Sensor timeline: the array-native replacement of the ROS transport layer.

The reference wires sensors to filters through ROS pub/sub callbacks feeding
mutex-guarded deques, and each filter node runs a wall-clock timer that
consumes the *latest* entry of each queue per tick
(``ekf_localization.cpp:218-252,547-624``, ``odom_provider.cpp:240-324``).

Here the whole mission is materialized up front as a struct-of-arrays
*timeline*: a fixed tick grid (the timer), and for every sensor channel the
per-tick snapshot of "latest message at or before this tick", plus freshness
metadata. Building the snapshot is a host-side numpy `searchsorted` done once
per mission; after that, replay is a single `lax.scan` over time with no
host↔device traffic. Dropouts are expressed as validity masks — which is also
the fault-injection mechanism (SURVEY.md §5).

Builders return NUMPY-leaved pytrees: host building is pure numpy, and
`parallel.fleet.batch_timelines` stacks missions on host and issues ONE
`jax.device_put` per batched leaf instead of one small transfer per mission
and leaf. Single-mission numpy timelines fed straight to a jitted replay
are transferred at the call boundary exactly like device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import numpy as np
import jax.numpy as jnp


def _pytree_dataclass(cls=None, *, static=()):
    """Frozen dataclass registered as a JAX pytree: every field is a child
    except the names in ``static``, which go into the treedef (hashable,
    compared on retrace). Instances get ``.replace(**changes)``."""
    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        names = [f.name for f in dataclasses.fields(c)]
        jax.tree_util.register_dataclass(
            c, data_fields=[n for n in names if n not in static],
            meta_fields=list(static))
        c.replace = lambda self, **changes: dataclasses.replace(self, **changes)
        return c

    return wrap if cls is None else wrap(cls)


@_pytree_dataclass
class Channel:
    """Per-tick snapshot of one sensor channel.

    value:  (T, D)   latest payload at or before each tick (zeros if none yet)
    stamp:  (T,)     stamp of that payload (-inf if none)
    valid:  (T,)     any message received at or before this tick
    fresh:  (T,)     a new message arrived since the previous tick
    age:    (T,)     tick_time - stamp (staleness, used for dropout gating)
    """

    value: jnp.ndarray
    stamp: jnp.ndarray
    valid: jnp.ndarray
    fresh: jnp.ndarray
    age: jnp.ndarray


@_pytree_dataclass
class WindowChannel:
    """Like Channel, but carrying the last W stamped messages per tick —
    needed by the Bézier DVL interpolation (``odom_provider.cpp:126-165``)
    which extrapolates over the most recent window of readings.

    value:  (T, W, D)  last W payloads (oldest..newest); row repeats oldest
                       available when fewer than W messages have arrived
    stamp:  (T, W)
    count:  (T,)       number of real messages in the window (<= W)
    """

    value: jnp.ndarray
    stamp: jnp.ndarray
    count: jnp.ndarray


@_pytree_dataclass
class EventChannel:
    """Sparse per-tick event sets (landmark detections): measurements are
    delivered in bursts; each tick sees at most one burst (the reference pops
    one PoseArray per tick, ``ekf_localization.cpp:479-524``).

    value: (T, K, D) padded detections assigned to each tick
    mask:  (T, K)    which detection slots are real
    """

    value: jnp.ndarray
    mask: jnp.ndarray


def _latest_index(stamps: np.ndarray, ticks: np.ndarray) -> np.ndarray:
    """Index of latest stamp <= tick, -1 if none."""
    return np.searchsorted(stamps, ticks, side="right") - 1


def make_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,
    dtype=np.float32,
) -> Channel:
    """Build a latest-value Channel from raw stamped messages (host side)."""
    stamps = np.asarray(stamps, dtype=np.float64)
    values = np.asarray(values, dtype=dtype)
    if values.ndim == 1:
        values = values[:, None]
    if values.shape[0] != stamps.shape[0]:
        raise ValueError("values/stamps length mismatch")
    if len(stamps) == 0:
        # channel with no messages: permanently invalid (sensor dropout)
        T, D = len(ticks), max(values.shape[1] if values.ndim == 2 else 1, 1)
        return Channel(
            value=np.zeros((T, D), dtype),
            stamp=np.full((T,), -np.inf, dtype),
            valid=np.zeros((T,), bool),
            fresh=np.zeros((T,), bool),
            age=np.full((T,), np.inf, dtype),
        )
    order = np.argsort(stamps, kind="stable")
    stamps, values = stamps[order], values[order]

    idx = _latest_index(stamps, ticks)
    valid = idx >= 0
    safe = np.maximum(idx, 0)
    value = values[safe]
    value[~valid] = 0.0
    stamp = np.where(valid, stamps[safe], -np.inf)
    prev_idx = np.concatenate([[-1], idx[:-1]])
    fresh = valid & (idx != prev_idx)
    age = np.where(valid, ticks - stamp, np.inf)
    return Channel(
        value=np.ascontiguousarray(value),
        stamp=stamp.astype(dtype),
        valid=valid,
        fresh=fresh,
        age=age.astype(dtype),
    )


def make_window_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,
    window: int,
    dtype=np.float32,
) -> WindowChannel:
    stamps = np.asarray(stamps, dtype=np.float64)
    values = np.atleast_2d(np.asarray(values, dtype=dtype))
    order = np.argsort(stamps, kind="stable")
    stamps, values = stamps[order], values[order]

    idx = _latest_index(stamps, ticks)  # (T,)
    offs = np.arange(-(window - 1), 1)  # oldest..newest
    widx = idx[:, None] + offs[None, :]
    count = np.clip(idx + 1, 0, window)
    widx = np.clip(widx, 0, max(len(stamps) - 1, 0))
    if len(stamps) == 0:
        raise ValueError("window channel needs at least one message")
    return WindowChannel(
        value=np.ascontiguousarray(values[widx]),
        stamp=stamps[widx].astype(dtype),
        count=count.astype(np.int32),
    )


def make_event_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,  # (M, D) one row per detection
    burst_id: np.ndarray,  # (M,) groups detections into bursts
    max_per_tick: int,
    dtype=np.float32,
    stats: Optional[dict] = None,
) -> EventChannel:
    """Assign each detection burst to the first tick at/after its stamp.

    Mirrors queue semantics: detections wait in the queue and are consumed by
    the next filter tick. Bursts landing on the same tick are merged up to
    max_per_tick (extra detections are dropped — the reference's queue would
    instead delay them one tick; at filter rates this is equivalent). Any
    drop is surfaced: the count lands in ``stats["dropped"]`` when a stats
    dict is passed and a warning is emitted, so saturation (silent
    measurement loss) is observable in replays.
    """
    T = len(ticks)
    D = values.shape[1] if values.size else 3
    dropped = 0
    if len(stamps):
        order = np.argsort(stamps, kind="stable")
        stamps, values, burst_id = stamps[order], values[order], np.asarray(burst_id)[order]
        # native binner when available (the only O(events) loop in
        # preprocessing; matters for multi-hour recorded missions)
        from .. import native

        binned = native.bin_events(stamps, values, burst_id, ticks, max_per_tick)
        if binned is not None:
            out_v, out_m, dropped = binned
            _record_dropped(dropped, stats)
            return EventChannel(
                value=out_v.astype(dtype), mask=np.ascontiguousarray(out_m)
            )
    out = np.zeros((T, max_per_tick, D), dtype=dtype)
    mask = np.zeros((T, max_per_tick), dtype=bool)
    if len(stamps):
        tick_of = np.searchsorted(ticks, stamps, side="left")
        fill = np.zeros(T, dtype=np.int64)
        for m in range(len(stamps)):
            t = tick_of[m]
            if t >= T:  # event after mission end — lost, like saturation
                dropped += 1
                continue
            k = fill[t]
            if k < max_per_tick:
                out[t, k] = values[m]
                mask[t, k] = True
                fill[t] += 1
            else:
                dropped += 1
    _record_dropped(dropped, stats)
    return EventChannel(value=out, mask=mask)


def _record_dropped(dropped: int, stats: Optional[dict]) -> None:
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + int(dropped)
    if dropped:
        import warnings

        warnings.warn(
            f"event channel saturated: {int(dropped)} detections beyond "
            "max_per_tick were dropped (raise max_per_tick or the tick rate)",
            stacklevel=3,
        )


@_pytree_dataclass(static=("dt",))
class Timeline:
    """A full mission timeline on a fixed tick grid.

    ticks: (T,) tick times [s]; dt: tick period (static); channels: named
    sensor snapshots.
    """

    ticks: jnp.ndarray
    dt: float
    channels: Dict[str, Channel] = dataclasses.field(default_factory=dict)
    windows: Dict[str, WindowChannel] = dataclasses.field(default_factory=dict)
    events: Dict[str, EventChannel] = dataclasses.field(default_factory=dict)

    @property
    def num_ticks(self) -> int:
        return self.ticks.shape[0]

    def slice_tick(self, k):
        """Per-tick pytree view (used as the scan xs element)."""
        return jax.tree_util.tree_map(lambda x: x[k], self)


def make_ticks(t0: float, t1: float, freq_hz: float) -> np.ndarray:
    n = int(np.floor((t1 - t0) * freq_hz)) + 1
    return (t0 + np.arange(n) / freq_hz).astype(np.float64)


def build_timeline(
    t0: float,
    t1: float,
    freq_hz: float,
    channels: Optional[Dict[str, tuple]] = None,   # name -> (stamps, values)
    windows: Optional[Dict[str, tuple]] = None,    # name -> (stamps, values, W)
    events: Optional[Dict[str, tuple]] = None,     # name -> (stamps, values, burst_id, K)
    dtype=np.float32,
    stats: Optional[dict] = None,   # out-param: per-event-channel build stats
) -> Timeline:
    ticks = make_ticks(t0, t1, freq_hz)
    chan = {
        name: make_channel(ticks, s, v, dtype) for name, (s, v) in (channels or {}).items()
    }
    win = {
        name: make_window_channel(ticks, s, v, w, dtype)
        for name, (s, v, w) in (windows or {}).items()
    }
    ev = {}
    for name, (s, v, b, k) in (events or {}).items():
        ch_stats: dict = {}
        ev[name] = make_event_channel(ticks, s, v, b, k, dtype, stats=ch_stats)
        if stats is not None:
            stats[name] = ch_stats
    return Timeline(
        ticks=ticks.astype(dtype),
        dt=float(1.0 / freq_hz),
        channels=chan,
        windows=win,
        events=ev,
    )
