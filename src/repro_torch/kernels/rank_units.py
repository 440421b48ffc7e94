"""The paged kernels' work plan on the host: units of valid tokens.

The paged kernels (``csrc/micro_attn_decode.cu`` and
``csrc/micro_attn_prefill.cu``: one kernel a dtype each, the single-rank
form at NR = 1) plan their work on the card, from the tables, with
``plan_units`` and ``segment_at`` of ``csrc/paged_attn.cuh``. This module
is the same integer arithmetic in Python. The CPU tests hold it to the
plan's properties (every valid token of every (rank, request) pair in
exactly one unit, no unit past a tail or over ``U`` tokens, no unit on an
empty pair, one scratch slot a partial) and emulate the kernels' merges
with it through the plain twins. ``tile_boxes`` is the paged kernels'
TMA loads of a run of tiles: one box a table block's share of a tile;
``segment_boxes`` the producer warps' over a segment's units, rank by
rank, each box of one rank's pool.

The plan. Pair (rank k, request r) holds ``S[k, r]`` valid tokens (the
tables' valid slots are a prefix; the last holds ``tail`` tokens), cut
into ``ceil(S / U)`` units of at most ``U`` tokens. A merge row ``rho`` is
what one output row merges: request ``r = rho`` over every rank (merged),
or pair ``rho = k * R + r`` alone (stacked). Each merge row has ``HG``
head groups; merge group ``g = rho * HG + h`` holds the units of its
pairs, rank by rank. The groups' units are numbered one after another,
``T`` in all, and block ``b`` of the first ``B' = min(B, T)`` blocks
takes units ``[b * T // B', (b + 1) * T // B')`` (none empty): a few runs
(segments) of one group each, one partial a segment, stored in scratch
slot ``b + g`` unless it is its group's only partial.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def pair_tokens(tables, tails, bs: int) -> np.ndarray:
    """Valid tokens of each pair: tables ``[NR, R, MB]`` (valid slots a
    prefix), tails ``[NR, R]`` (clamped to ``[0, bs]`` as the kernels
    read them) -> ``S [NR, R]``."""
    tables = np.asarray(tables)
    nv = (tables >= 0).sum(-1)
    tail = np.clip(np.asarray(tails).reshape(nv.shape), 0, bs)
    return np.where(nv > 0, (nv - 1) * bs + tail, 0).astype(np.int64)


def unit_plan(S, U: int, HG: int, stacked: bool) -> Dict[str, object]:
    """The plan of ``S [NR, R]`` valid tokens: units a pair (``n``), each
    merge row's first unit (``cum``, P + 1 entries), ``T`` units in all."""
    S = np.asarray(S, np.int64)
    NR, R = S.shape
    n = -(-S // U)
    per_row = n.reshape(-1) if stacked else n.sum(0)
    cum = np.concatenate([[0], np.cumsum(per_row * HG)]).astype(np.int64)
    return {"NR": NR, "R": R, "U": U, "HG": HG, "stacked": stacked,
            "P": len(per_row), "S": S, "n": n, "cum": cum,
            "T": int(cum[-1])}


def card_unit(S, U: int, tile: int, HG: int, min_units: int) -> int:
    """The unit a decode kernel's plan takes on the card
    (``plan_units``' ``min_units``): ``U`` halved, down to ``tile``,
    while the valid tokens ``S [NR, R]`` make fewer than ``min_units``
    units over every head group (``min_units`` 0: ``U``)."""
    S = np.asarray(S, np.int64)
    while (min_units > 0 and U > tile
           and HG * int((-(-S // U)).sum()) < min_units):
        U //= 2
    return U


def busy_blocks(plan, B: int) -> int:
    """Blocks that take units: ``min(B, T)``, so that none takes none."""
    return min(B, max(plan["T"], 1))


def block_of(plan, p: int, B: int) -> int:
    """The block holding unit ``p`` (``B`` busy blocks)."""
    return ((p + 1) * B - 1) // plan["T"]


def _ranks(plan, rho: int):
    R = plan["R"]
    if plan["stacked"]:
        return rho % R, [rho // R]
    return rho, list(range(plan["NR"]))


def segments(plan, b: int, B: int) -> List[Dict[str, object]]:
    """Block ``b``'s segments, in order: merge group ``g`` (``rho``, head
    group ``h``), request ``r``, its units ``[(k, j, lo, hi)]`` (rank,
    unit, tokens [lo, hi)), the group's partials (``first``: its first
    block, ``parts``) and the scratch slot of this partial (``slot``)."""
    T, HG, U, cum = plan["T"], plan["HG"], plan["U"], plan["cum"]
    B = busy_blocks(plan, B)
    if b >= B:
        return []
    p, p1 = b * T // B, (b + 1) * T // B
    out = []
    while p < p1:
        rho = int(np.searchsorted(cum, p, side="right")) - 1
        tr = int(cum[rho + 1] - cum[rho]) // HG
        within = p - int(cum[rho])
        h, q0 = divmod(within, tr)
        first = int(cum[rho]) + h * tr
        end = first + tr
        q1 = q0 + min(p1, end) - p
        r, ranks = _ranks(plan, rho)
        units, off = [], 0
        for k in ranks:
            nk = int(plan["n"][k, r])
            for j in range(max(q0, off) - off, min(q1, off + nk) - off):
                units.append((k, j, j * U,
                              min((j + 1) * U, int(plan["S"][k, r]))))
            off += nk
        fb = block_of(plan, first, B)
        parts = block_of(plan, end - 1, B) - fb + 1
        g = rho * HG + h
        out.append({"g": g, "rho": rho, "h": h, "r": r, "units": units,
                    "first": fb, "parts": parts,
                    "slot": b + g if parts > 1 else None})
        p = min(p1, end)
    return out


def all_segments(plan, B: int) -> List[Dict[str, object]]:
    """Every block's segments, each with its block ``b``."""
    return [dict(seg, b=b) for b in range(B) for seg in segments(plan, b, B)]


def box_rows(bs: int, tile: int) -> int:
    """Tokens a TMA box of the paged kernels: gcd(bs, tile), so a
    box never crosses a table block and the boxes tile a tile."""
    return math.gcd(bs, tile)


def tile_boxes(table_row, bs: int, lo: int, hi: int,
               tile: int) -> List[Dict[str, object]]:
    """The boxes the producer warp issues for tokens ``[lo, hi)`` of one
    table row (valid tokens, ``lo`` a multiple of ``tile``), a tile at a
    time: tile ``t0`` gets box b (b < ceil(min(tile, hi - t0) / rows))
    at tokens ``[t0 + b * rows, ...)``, rows ``[off, off + rows)`` of
    block ``table[t // bs]``. Returns ``[{"t0", "boxes": [(t, blk, off,
    rows)]}]``."""
    rows = box_rows(bs, tile)
    out = []
    for t0 in range(lo, hi, tile):
        nb = -(-min(tile, hi - t0) // rows)
        boxes = []
        for b in range(nb):
            t = t0 + b * rows
            boxes.append((t, int(table_row[t // bs]), t % bs, rows))
        out.append({"t0": t0, "boxes": boxes})
    return out


def segment_boxes(tables, bs: int, units, tile: int
                  ) -> List[Dict[str, object]]:
    """The boxes a unit kernel's producer warp issues for a segment's
    ``units`` (``segments``' ``(k, j, lo, hi)``), in order: ``tile_boxes``
    on rank k's table row ``tables[k]`` over each unit's tokens, a tile
    at a time (the prefill kernels' unit is one tile; the decode
    kernel's up to U / tile). Returns ``[{"k", "t0", "valid", "last",
    "boxes": [(k, blk, off, rows)]}]``: box b of a tile holds ``rows``
    pool rows from ``off`` of block ``blk`` of rank k's pool, the tile's
    tokens ``[t0 + b * rows, ...)``, of which the first ``valid`` are the
    tile's; ``last`` marks the segment's last tile (the decode kernel
    tags its ring stage with ``valid`` and ``last``)."""
    out = []
    for k, _, lo, hi in units:
        for t in tile_boxes(tables[k], bs, lo, hi, tile):
            out.append({"k": k, "t0": t["t0"],
                        "valid": min(tile, hi - t["t0"]), "last": False,
                        "boxes": [(k, blk, off, rows)
                                  for _, blk, off, rows in t["boxes"]]})
    if out:
        out[-1]["last"] = True
    return out
