"""``chip_smoke.py``'s ServeLayout decode loop (``decode_run``), on the CPU.

``decode_run`` writes each new token into its request's last block,
after the rows the owner's tail holds. A context that fills its last
block (S % bs == 0) would have its rows overwritten, and one whose free
rows are fewer than the steps would write past the block: both are
refused with a ValueError before any step runs. ``spare_blocks`` gives
each request an empty block to decode into (the placement job's smoke
sizes, where every multiple of 16 fills its 8-token last block). Most
tests replace the step by a spy and hold decode_run's bookkeeping (which
block, which row, which tail); the last two run real steps: one process
against the dense greedy stream, and the placement job in a spawned
2-process gloo group (about 7 s).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.serving import sharded_step as ss  # noqa: E402

B, NP, NDATA = 2, 4, 2


def _context(S, bs):
    """Pools [1, NP, NB, bs, 1, 1] and ``layout_tables`` of a B x S
    prefill in the data-local layout."""
    wb, _, nbl = ss.prefill_layout(B, S, bs, NP, n_data=NDATA)
    tabs = chip_smoke.layout_tables(wb, nbl, S, bs, -(-S // bs) + 1)
    pools = tuple(torch.zeros((1, NP, nbl, bs, 1, 1)) for _ in range(2))
    return pools, tabs


class _StepSpy:
    """Stands in for the decode steps: records each call's tails, write
    blocks and write rows, returns logits that pick token 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, params, cfg, layout, pk, pv, tables, nblk, tails, wb,
                 wo, tok, lens, mesh=None, return_logits=False):
        self.calls.append({"tables": tables.copy(), "tails": tails.copy(),
                           "wb": wb.copy(), "wo": wo.copy(),
                           "lens": lens.copy()})
        return torch.zeros((tables.shape[1], 3)), pk, pv


@pytest.fixture
def spy(monkeypatch):
    s = _StepSpy()
    monkeypatch.setattr(ss, "serve_decode_step", s)
    monkeypatch.setattr(ss, "serve_decode_step_opt", s)
    return s


def _run(pools, tabs, S, bs, steps, opt=False):
    return chip_smoke.decode_run(None, None, None, pools, tabs, S, bs,
                                 np.zeros(B, np.int64), steps, opt=opt,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("S,bs", [(64, 8), (2048, 128), (512, 128)])
def test_decode_run_refuses_a_full_last_block(spy, S, bs):
    """The placement job's former sizes: every last block is full."""
    pools, tabs = _context(S, bs)
    with pytest.raises(ValueError, match="last block is full"):
        _run(pools, tabs, S, bs, 3)
    assert spy.calls == []


def test_decode_run_refuses_a_decode_past_the_last_block(spy):
    pools, tabs = _context(60, 8)          # 4 rows in the last block
    with pytest.raises(ValueError, match="would leave"):
        _run(pools, tabs, 60, 8, 5)
    assert spy.calls == []


@pytest.mark.parametrize("opt", [False, True])
def test_decode_run_writes_after_the_last_row(spy, opt):
    """A ragged context: step s writes row S % bs + s of the last block,
    on its owner shard only; the owner's tail counts the new row in the
    writing schedule and not in the other (tails exclude it there)."""
    S, bs, steps = 2032, 128, 4
    pools, tabs = _context(S, bs)
    tables, tails, owner, last = tabs
    _run(pools, tabs, S, bs, steps, opt=opt)
    assert len(spy.calls) == steps
    rows = np.arange(B)
    for s, c in enumerate(spy.calls):
        assert (c["wb"][owner, rows] == last).all()
        assert (c["wo"][owner, rows] == S % bs + s).all()
        assert (c["tails"][owner, rows] ==
                tails[owner, rows] + s + (0 if opt else 1)).all()
        assert (c["lens"] == S + s).all()


@pytest.mark.parametrize("S", [64, 32])
def test_spare_blocks_take_the_smoke_decode(spy, S):
    """PLACEMENT_SMOKE's S and moe_S: each request decodes into an empty
    block its owner's table gains (rows 0, 1, ...), the context's blocks
    untouched; the pools grow by one block a request."""
    bs, steps = 8, 3
    pools, tabs = _context(S, bs)
    nb = pools[0].shape[2]
    grown, spare = chip_smoke.spare_blocks(pools, tabs)
    tables, tails, owner, last = spare
    rows = np.arange(B)
    assert grown[0].shape[2] == nb + B and (grown[0][:, :, nb:] == 0).all()
    assert (last == nb + rows).all() and (tails[owner, rows] == 0).all()
    n_before = (tabs[0] >= 0).sum(-1)
    assert ((tables >= 0).sum(-1) - n_before == 0).sum() == NP * B - B
    assert (tables[owner, rows, n_before[owner, rows]] == last).all()
    _run(grown, spare, S, bs, steps)
    for s, c in enumerate(spy.calls):
        assert (c["wb"][owner, rows] == last).all()
        assert (c["wo"][owner, rows] == s).all()
        assert (c["tails"][owner, rows] == s + 1).all()


def test_placement_sizes_leave_room_in_the_last_block():
    """The placement job decodes from ragged contexts that the
    sequence-parallel prefill takes (multiples of 16); the smoke sizes
    fill their blocks and take spare ones."""
    ph = chip_smoke.PLACEMENT
    for S, steps in ((ph["S"], ph["steps"]), (ph["moe_S"], ph["moe_steps"])):
        assert S % 16 == 0 and 0 < S % ph["bs"]
        assert S % ph["bs"] + steps <= ph["bs"]
    sm = chip_smoke.PLACEMENT_SMOKE
    assert sm["S"] % sm["bs"] == 0 and sm["moe_S"] % sm["bs"] == 0


@pytest.mark.parametrize("opt", [False, True])
def test_spare_blocks_decode_the_dense_greedy_stream(opt):
    """Real steps at PLACEMENT_SMOKE's sizes: a float32 smoke model's
    64-token context fills its 8-token blocks; decoded into spare blocks
    (tail 0 before the first write: the opt schedule's first step reads
    none of its rows) with either schedule, it gives the dense greedy
    stream (``prefill`` then ``decode_step``)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.models.prefill import prefill
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              dtype="float32", num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), cpu)
    layout = ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    S, bs, steps = chip_smoke.PLACEMENT_SMOKE["S"], 8, 3
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    sh = {"bs": bs, "NP": NP, "n_data": NDATA}
    first, pools, _, _ = chip_smoke.sl_prefill(params, cfg, layout, toks,
                                               sh, cpu)
    wb, _, nbl = ss.prefill_layout(B, S, bs, NP, n_data=NDATA)
    tabs = chip_smoke.layout_tables(wb, nbl, S, bs, -(-S // bs) + 1)
    pools, tabs = chip_smoke.spare_blocks(pools, tabs)
    lg, st = prefill(params, cfg, torch.from_numpy(toks),
                     max_len=S + steps + 1)
    want = [torch.argmax(lg, -1)]
    for _ in range(steps):
        lg, st = decode_step(params, cfg, st, want[-1])
        want.append(torch.argmax(lg, -1))
    want = torch.stack(want).numpy()
    assert np.array_equal(first.numpy(), want[0])
    got, *_ = chip_smoke.decode_run(params, cfg, layout, pools, tabs, S, bs,
                                    want[0], steps, opt=opt, device=cpu)
    assert np.array_equal(got, want[1:])


def test_placement_job_rehearses_with_spare_blocks():
    """The placement job of a spawned 2-process gloo group at
    PLACEMENT_SMOKE's sizes, as chip_smoke's mesh phase runs it on the
    CPU: every run (qwen3 on (1, 2), qwen2-moe) decodes into spare blocks
    grown onto this process's slabs, the sequence-parallel prefill's
    pools too, and ``placement_check`` passes (equal streams in both
    processes, the float32 parity run equal to the single process)."""
    job = {"device": "cpu", "smoke": True, "placement": True,
           "arch": "qwen3-0.6b", "layers": None,
           "prompts": [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [3, 4, 5, 6, 7]],
           "n_new": 4}
    runs, _ = chip_smoke.run_mesh_group(2, job)
    p = runs[0]["placement"]
    assert p["runs"]["(1, 2)"]["spare_blocks"] and p["moe"]["spare_blocks"]
    rep = chip_smoke.placement_check(runs, 2, job, torch.device("cpu"), {})
    assert rep["runs"]["(1, 2)"]["seq_parallel"]["stream_equals_plain"]
