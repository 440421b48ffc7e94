"""The port's host-DRAM KV tier against the JAX package's.

``repro_torch.serving.hosttier.HostKVTier`` keeps frames as torch
tensors (pinned host tensors filled by an asynchronous copy on the card;
the gathered rows themselves on the CPU, where every copy is
synchronous). Held against ``repro.serving.hosttier.HostKVTier`` on the
same numpy-made frames:

* a put/get round trip returns the bytes that went in, and a corrupted
  frame is caught by verification;
* the frame checksum (CRC32 over the raw bytes, K then V) equals the JAX
  tier's over the same frame, in float32 and in bf16 (a bf16 frame
  hashes as its 16-bit patterns on both sides);
* under one seeded sequence of puts, gets, pins, unpins, drops and
  drains, both tiers hold the same keys, evict the same keys in the same
  order (LRU under the watermark pair, pins and the ``evictable_fn``
  veto skipped) and count the same statistics after every operation;
* ``backoff_delay_s`` equals the JAX package's.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro.serving.hosttier import HostKVTier as JaxTier
from repro_torch.serving import faults as pfaults
from repro_torch.serving.faults import FrameCorruptionError
from repro_torch.serving.hosttier import HostKVTier, frame_crc32

SHAPE = (2, 4, 2, 8)        # [L, block_size, K, hd]


def _frame(rng):
    return tuple(rng.standard_normal(SHAPE).astype(np.float32)
                 for _ in range(2))


def test_put_get_round_trip_and_corruption_is_caught():
    rng = np.random.default_rng(0)
    tier = HostKVTier(4, verify=True)
    k, v = _frame(rng)
    assert tier.put("a", torch.from_numpy(k), torch.from_numpy(v))
    assert "a" in tier and tier.used_blocks == 1
    tier.drain()
    gk, gv = tier.get("a")
    np.testing.assert_array_equal(gk.numpy(), k)
    np.testing.assert_array_equal(gv.numpy(), v)
    assert tier.stats.spilled_bytes == tier.stats.fetched_bytes == \
        k.nbytes + v.nbytes
    assert tier.get("missing") is None
    tier.fault_hook = lambda key: "corrupt"
    with pytest.raises(FrameCorruptionError):
        tier.get("a")
    assert "a" not in tier and tier.stats.corruptions == 1
    # The frame handed out before the corruption is untouched.
    np.testing.assert_array_equal(gk.numpy(), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checksum_equals_the_jax_tiers_on_the_same_bytes(dtype):
    rng = np.random.default_rng(1)
    bits = [rng.integers(0, 2 ** 16, SHAPE, dtype=np.uint16)
            for _ in range(2)]
    if dtype == "float32":
        arrays = [rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(2)]
        jax_frame = [jnp.asarray(a) for a in arrays]
        torch_frame = [torch.from_numpy(a.copy()) for a in arrays]
    else:
        jax_frame = [jnp.asarray(b).view(jnp.bfloat16) for b in bits]
        torch_frame = [torch.from_numpy(b.view(np.int16).copy())
                       .view(torch.bfloat16) for b in bits]
    jt, pt = JaxTier(2, verify=True), HostKVTier(2, verify=True)
    jt.put("f", *jax_frame)
    pt.put("f", *torch_frame)
    jt.drain(block=True)
    pt.drain(block=True)
    assert pt._sums["f"] == jt._sums["f"]
    assert frame_crc32(tuple(torch_frame)) == jt._sums["f"]
    if dtype == "bfloat16":
        # The JAX tier's bf16 hash is the hash of the 16-bit patterns.
        assert pt._sums["f"] == JaxTier._checksum(tuple(bits))


def _drive(seed, capacity, high, low):
    """One seeded op sequence through both tiers; compares their state
    after every op."""
    rng = random.Random(seed)
    frames = np.random.default_rng(seed)
    vetoed = set()
    evicted = {"jax": [], "port": []}
    jt = JaxTier(capacity, high_watermark=high, low_watermark=low,
                 on_evict=evicted["jax"].append,
                 evictable_fn=lambda key: key not in vetoed)
    pt = HostKVTier(capacity, high_watermark=high, low_watermark=low,
                    on_evict=evicted["port"].append,
                    evictable_fn=lambda key: key not in vetoed)
    keys = list(range(12))
    for _ in range(80):
        op = rng.choice(["put", "put", "put", "get", "pin", "unpin",
                         "drop", "drain", "veto"])
        key = rng.choice(keys)
        if op == "put":
            k, v = _frame(frames)
            assert jt.put(key, k, v) == pt.put(key, torch.from_numpy(k),
                                               torch.from_numpy(v))
        elif op == "get":
            want, got = jt.get(key), pt.get(key)
            assert (want is None) == (got is None)
            if want is not None:
                np.testing.assert_array_equal(got[0].numpy(), want[0])
                np.testing.assert_array_equal(got[1].numpy(), want[1])
        elif op == "pin":
            jt.pin(key)
            pt.pin(key)
        elif op == "unpin":
            jt.unpin(key)
            pt.unpin(key)
        elif op == "drop":
            jt.drop(key)
            pt.drop(key)
        elif op == "drain":
            block = rng.random() < 0.5
            jt.drain(block=block)
            pt.drain(block=block)
        else:
            vetoed.symmetric_difference_update({key})
        assert sorted(k for k in keys if k in jt) == \
            sorted(k for k in keys if k in pt)
        assert jt.used_blocks == pt.used_blocks <= capacity
        assert jt.pinned == pt.pinned
        assert evicted["jax"] == evicted["port"]
        for f in ("spilled_bytes", "fetched_bytes", "spills", "fetches",
                  "fetch_stalls", "evictions", "rejected"):
            assert getattr(jt.stats, f) == getattr(pt.stats, f), f
    return evicted["port"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("capacity,high,low", [(5, 0.9, 0.7),
                                               (6, 1.0, 1.0),
                                               (8, 0.75, 0.5)])
def test_lru_pins_and_watermarks_agree_with_jax(seed, capacity, high, low):
    evicted = _drive(seed, capacity, high, low)
    if capacity == 5:
        assert evicted, "the sequence never evicted"


def test_backoff_delay_equals_jax():
    for attempt in range(8):
        for base, cap in ((0.0, 0.05), (0.001, 0.05), (0.01, 0.02)):
            assert pfaults.backoff_delay_s(attempt, base, cap) == \
                jfaults.backoff_delay_s(attempt, base, cap)
    plan = dict(n_steps=20, n_instances=3, n_events=5)
    assert pfaults.FaultPlan.from_seed(7, **plan).events == tuple(
        pfaults.FaultEvent(**vars(e))
        for e in jfaults.FaultPlan.from_seed(7, **plan).events)
