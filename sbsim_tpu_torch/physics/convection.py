"""Stochastic intra-room convection as random temperature swapping.

The reference models in-room air mixing by randomly swapping CV temperatures
within each room (stochastic_convection_simulator.py:35-145). Port of
sbsim_tpu/physics/convection.py, both methods:

  * "swap": R rounds of masked pair swaps on the grid, each round pairing
    cell x with x+o for a static offset o and swapping each pair with a
    per-env Bernoulli decision, packed one bit per round into a decision
    word per cell. The words come from the "mix32" counter hash keyed by
    the per-env step key, or from threefry bits of that key (rng.bits);
  * "argsort": a uniform random permutation within each room tile, by one
    stable argsort of segment_id * 2 + u over the room cells.

  * make_convection_buckets: host numpy, identical schedule, lead masks,
    packed lead/follower words and argsort segments
    (np.random.RandomState(seed) picks the extra rounds exactly as the JAX
    package does);
  * swap_decision_word / decision_word_from_key: the packed per-cell
    decision word, bitwise equal to the JAX package's (int64 arithmetic
    masked to 32 bits);
  * apply_swaps_with_word, apply_argsort and apply_convection over a
    (B, H, W) batch with (B, 2) keys (the JAX package's vmap written out).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.core.geometry import BuildingGeometry

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ConvectionBuckets:
    """Precomputed mixing structure (host numpy): lead_masks/offsets drive
    the "swap" method, flat_indices/segment_keys the "argsort" method."""

    lead_masks: np.ndarray  # bool (R, H, W): cells that initiate round r
    lead_words: np.ndarray  # uint32 (H, W): bit r = lead_masks[r] (packed)
    foll_words: np.ndarray  # uint32 (H, W): bit r = lead_masks[r] rolled by o_r
    flat_indices: np.ndarray  # int32 (n_room_cvs,): indices into temp.ravel()
    segment_keys: np.ndarray  # float32 (n_room_cvs,): segment_id * 2
    offsets: Tuple[Tuple[int, int], ...] = ()
    enabled: bool = False
    method: str = "swap"
    p_round: float = 0.5
    rng: str = "threefry"


def _offset_schedule(
    distance: int, h: int, w: int
) -> List[Tuple[int, int]]:
    """Swap offsets honoring the reference's squared-distance bound.

    distance == -1 (the reference's full-room-shuffle mode) uses a
    per-axis doubling ladder so repeated rounds mix across the whole room.
    """
    if distance == -1:
        offsets: List[Tuple[int, int]] = []
        step = 1
        while step <= max(1, max(h, w) // 2):
            if step < w:
                offsets.append((0, step))
            if step < h:
                offsets.append((step, 0))
            step *= 2
        return offsets or [(0, 1), (1, 0)]
    offsets = []
    r = int(np.floor(np.sqrt(max(distance, 1))))
    for dy in range(0, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx <= 0:
                continue  # (0, dx<=0) is a duplicate of (0, -dx)
            if dy * dy + dx * dx <= distance:
                offsets.append((dy, dx))
    return offsets or [(0, 1), (1, 0)]


def _lead_mask(
    zone_ids: np.ndarray, n_zones: int, o: Tuple[int, int], phase: int
) -> np.ndarray:
    """Static coloring: cell x leads a swap with x+o.

    Leads are chosen by parity along the offset's primary axis so lead and
    follower sets are disjoint and each follower has exactly one lead (the
    round is a permutation); `phase` 0 pairs (2k, 2k+1) blocks, phase 1
    pairs (2k+1, 2k+2). Pairs must lie in the same room.
    """
    h, w = zone_ids.shape
    dy, dx = o
    ii, jj = np.indices((h, w))
    if dy != 0:
        parity = ((ii + phase * dy) // abs(dy)) % 2 == 0
    else:
        parity = ((jj + phase * dx) // abs(dx)) % 2 == 0
    in_room = zone_ids < n_zones
    partner_ok = np.zeros((h, w), bool)
    i0, i1 = max(0, -dy), h - max(0, dy)
    j0, j1 = max(0, -dx), w - max(0, dx)
    here = zone_ids[i0:i1, j0:j1]
    there = zone_ids[i0 + dy : i1 + dy, j0 + dx : j1 + dx]
    partner_ok[i0:i1, j0:j1] = (here == there) & (there < n_zones)
    return parity & in_room & partner_ok


def make_convection_buckets(
    geom: BuildingGeometry,
    p: float,
    distance: int,
    method: str = "swap",
    rounds: int = 0,
    variants: int = 0,
    seed: int = 5,
    rng: str = "threefry",
    schedule=None,
) -> ConvectionBuckets:
    """Precomputes the mixing structure.

    For "swap": rounds r and per-round swap probability p_round are sized
    so expected participations per CV ~= 2p (`rounds`=0 -> auto);
    `schedule` (a sequence of (dy, dx, phase) triples) overrides the seeded
    selection. For "argsort": the room cells in segment order and their
    keys. `variants` is unused (kept for config compatibility).
    """
    del variants
    if rng not in ("threefry", "mix32"):
        raise ValueError(f"unknown convection rng {rng!r}")
    zone_ids = np.asarray(geom.zone_ids)
    h, w = zone_ids.shape
    flat = np.flatnonzero((zone_ids < geom.n_zones).ravel())
    rooms = zone_ids.ravel()[flat].astype(np.int64)
    # Argsort segments: the room, or the room cut into tiles of the swap
    # distance, so shuffling never crosses a wall.
    if distance == -1:
        segments = rooms
    else:
        radius = max(1, int(np.ceil(np.sqrt(max(distance, 1)))))
        tile = 2 * radius + 1
        rows, cols = np.divmod(flat, w)
        tile_ids = (rows // tile) * ((w // tile) + 1) + (cols // tile)
        segments = rooms * (tile_ids.max() + 1) + tile_ids
    _, segments = np.unique(segments, return_inverse=True)
    order = np.argsort(segments, kind="stable")
    argsort = (flat[order], segments[order])

    enabled = bool(p != 0 and distance != 0)
    p_round = 0.5
    if not enabled or method != "swap":
        return _finish_buckets(
            np.zeros((1, h, w), bool), ((0, 1),), argsort, enabled, method,
            p_round, rng,
        )
    in_bound = _offset_schedule(distance, h, w)
    if schedule is not None:
        chosen = [((dy, dx), ph) for dy, dx, ph in schedule]
        if not 0 < len(chosen) <= 32:
            raise ValueError(
                f"explicit schedule has {len(chosen)} rounds; need "
                "1..32 (swap decisions pack one bit per round into a "
                "uint32 word)"
            )
        bound = set(in_bound)
        for (dy, dx), ph in chosen:
            if (dy, dx) not in bound or ph not in (0, 1):
                raise ValueError(
                    f"schedule entry ({dy}, {dx}, {ph}) outside the "
                    f"distance={distance} offset bound or phase range"
                )
        p_round = 2.0 * min(p, 1.0) / len(chosen)
        if p_round > 1.0:
            raise ValueError(
                f"explicit schedule of {len(chosen)} rounds gives "
                f"per-round swap probability {p_round:.3f} > 1 for p={p}"
            )
    else:
        # Core rounds: unit axis steps (or the full doubling ladder) in
        # BOTH parity phases, which makes each room's swap graph connected.
        if distance == -1:
            core = [(o, ph) for ph in (0, 1) for o in in_bound]
        else:
            core = [(o, ph) for ph in (0, 1) for o in ((0, 1), (1, 0))]
        extras = [
            (o, ph) for ph in (0, 1) for o in in_bound if (o, ph) not in core
        ]
        if rounds > 32:
            raise ValueError(
                f"ConvectionConfig rounds={rounds} exceeds 32: swap "
                "decisions pack one bit per round into a uint32 word"
            )
        if rounds <= 0:
            rounds = max(len(core), int(np.ceil(2.0 * min(p, 1.0) / 0.125)))
            if len(core) > 32:
                warnings.warn(
                    f"distance=-1 doubling-ladder core has {len(core)} "
                    "offsets but swap decisions pack 32 bits/word: the "
                    f"{len(core) - 32} largest-offset rounds are dropped",
                    stacklevel=2,
                )
            rounds = min(rounds, 32)
        p_round = 2.0 * min(p, 1.0) / rounds
        rs = np.random.RandomState(seed)
        chosen = list(core)
        while len(chosen) < rounds and extras:
            chosen.append(extras[rs.randint(len(extras))])
        chosen = chosen[:rounds]
    lead_masks = np.stack(
        [_lead_mask(zone_ids, geom.n_zones, o, ph) for o, ph in chosen]
    )
    offsets = tuple(o for o, _ in chosen)
    return _finish_buckets(
        lead_masks, offsets, argsort, enabled, method, p_round, rng
    )


def _finish_buckets(
    lead_masks, offsets, argsort, enabled, method, p_round, rng
) -> ConvectionBuckets:
    """Packs the per-round masks one bit per round into two uint32 planes:
    foll_words[y, x] bit r == lead_masks[r] rolled by offset r (the
    follower of a pair is the lead shifted by the round's offset)."""
    h, w = lead_masks.shape[1:]
    lead_words = np.zeros((h, w), np.uint32)
    foll_words = np.zeros((h, w), np.uint32)
    for r, (dy, dx) in enumerate(offsets):
        lead_words |= lead_masks[r].astype(np.uint32) << np.uint32(r)
        foll_words |= np.roll(
            lead_masks[r], (dy, dx), (0, 1)
        ).astype(np.uint32) << np.uint32(r)
    flat, segments = argsort
    return ConvectionBuckets(
        lead_masks=lead_masks,
        lead_words=lead_words,
        foll_words=foll_words,
        flat_indices=flat.astype(np.int32),
        segment_keys=segments.astype(np.float32) * np.float32(2.0),
        offsets=tuple(offsets),
        enabled=enabled,
        method=method,
        p_round=float(p_round),
        rng=rng,
    )


def _word_layout(buckets: ConvectionBuckets) -> Tuple[int, int, int, int]:
    """(n_rounds, n_planes, lane_bits, threshold_q) of the decision word.

    Decisions are Bernoulli(p_round) lanes of 32-bit random planes: 4-bit
    lanes when p_round is q/16 within 2% relative, else 8-bit lanes with
    q = round(256 p_round) (at least 1 for p_round > 0)."""
    n_rounds = len(buckets.offsets)
    q16 = int(round(buckets.p_round * 16.0))
    use4 = (
        buckets.p_round > 0.0
        and q16 >= 1
        and abs(q16 / 16.0 - buckets.p_round) <= 0.02 * buckets.p_round
    )
    lane_bits = 4 if use4 else 8
    lanes_per_plane = 32 // lane_bits
    n_planes = (n_rounds + lanes_per_plane - 1) // lanes_per_plane
    if use4:
        q = q16
    else:
        q = int(round(buckets.p_round * 256.0))
        if buckets.p_round > 0.0:
            q = max(q, 1)
    return n_rounds, n_planes, lane_bits, q


def decision_word_params(
    buckets: ConvectionBuckets,
) -> Optional[Tuple[int, int, int, int]]:
    """Static (n_rounds, n_planes, lane_bits, threshold_q) of the mix32
    decision word, which the kernels regenerate from the raw key, or None
    when swapping is disabled or rng != "mix32" (the kernels then read a
    precomputed word plane)."""
    if buckets.rng != "mix32" or not buckets.enabled:
        return None
    return _word_layout(buckets)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors of uint32 values."""
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def _pack_lanes(planes, params: Tuple[int, int, int, int]) -> torch.Tensor:
    """Bit r of the word = lane r of the random planes below q; `planes(p)`
    gives plane p as int64 uint32 values (B, H, W)."""
    n_rounds, n_planes, lane_bits, q = params
    lanes_per_plane = 32 // lane_bits
    lane_mask = (1 << lane_bits) - 1
    word = None
    for p in range(n_planes):
        bits = planes(p)
        if word is None:
            word = torch.zeros_like(bits)
        for lane in range(lanes_per_plane):
            r = p * lanes_per_plane + lane
            if r >= n_rounds:
                break
            v = (bits >> (lane_bits * lane)) & lane_mask
            word = word | ((v < q).to(torch.int64) << r)
    return word


def decision_word_from_key(
    keys: torch.Tensor,
    params: Tuple[int, int, int, int],
    shape: Tuple[int, int],
) -> torch.Tensor:
    """(B, 2) step keys -> (B, H, W) packed decision words (int64 holding
    uint32): bit r of word[b, y, x] = 1 iff cell (y, x) of env b, when it
    leads round r's pair, swaps. Two keyed murmur3 finalizer rounds over
    the plane-major cell counter, as the JAX package computes them."""
    h, w = shape
    k0 = keys[:, 0].view(-1, 1, 1)
    k1 = keys[:, 1].view(-1, 1, 1)
    cell = torch.arange(h * w, dtype=torch.int64, device=keys.device).view(h, w)

    def plane(p):
        idx = (cell + p * h * w) & MASK32
        return _fmix32(_fmix32(idx ^ k0) ^ k1)

    return _pack_lanes(plane, params)


def swap_decision_word(
    buckets: ConvectionBuckets, keys: torch.Tensor, shape: Tuple[int, int]
) -> torch.Tensor:
    """(B, 2) step keys -> (B, H, W) packed decision words (int64 holding
    uint32), bitwise the JAX package's swap_decision_word vmapped over the
    keys: the mix32 words for rng "mix32", else lanes of the threefry
    planes rng.bits(key, (n_planes, H, W))."""
    params = _word_layout(buckets)
    if buckets.rng == "mix32":
        return decision_word_from_key(keys, params, shape)
    bits = rng_lib.bits(keys, (params[1],) + tuple(shape))
    return _pack_lanes(lambda p: bits[:, p], params)


def apply_swaps_with_word(
    temp: torch.Tensor,
    offsets: Tuple[Tuple[int, int], ...],
    lead_words: torch.Tensor,
    foll_words: torch.Tensor,
    word: torch.Tensor,
) -> torch.Tensor:
    """R rounds of masked pair swaps on a (B, H, W) batch driven by the
    packed decision words (B, H, W); lead_words/foll_words are (H, W)
    int64 planes of uint32 values. Each round reads the field as it was
    before the round (a pair swap exchanges the two original values), and
    selects move values exactly, so room multisets are preserved bitwise."""
    out = temp
    dims = (-2, -1)
    rolled = {o: torch.roll(word, o, dims) for o in set(offsets)}
    for r, (dy, dx) in enumerate(offsets):
        bit = 1 << r
        swap_lead = ((word & bit) != 0) & ((lead_words & bit) != 0)
        swap_foll = ((rolled[(dy, dx)] & bit) != 0) & ((foll_words & bit) != 0)
        from_follower = torch.roll(out, (-dy, -dx), dims)
        from_lead = torch.roll(out, (dy, dx), dims)
        out = torch.where(swap_lead, from_follower, out)
        out = torch.where(swap_foll, from_lead, out)
    return out


def apply_argsort(
    temp: torch.Tensor,
    flat_indices: torch.Tensor,
    segment_keys: torch.Tensor,
    keys: torch.Tensor,
) -> torch.Tensor:
    """A uniform random permutation of the room cells within each segment,
    per env of a (B, H, W) batch: a stable argsort of segment_keys + u with
    u = rng.uniform over the room cells (segment_id * 2 + u < next id * 2,
    so segments stay contiguous). Stable as jnp.argsort is: the float32
    sums tie often at large segment ids, and ties keep cell order."""
    batch = temp.shape[0]
    flat = temp.reshape(batch, -1)
    vals = flat[:, flat_indices]
    u = rng_lib.uniform(keys, (flat_indices.shape[0],))
    order = torch.argsort(segment_keys + u, dim=-1, stable=True)
    out = flat.clone()
    out[:, flat_indices] = torch.gather(vals, 1, order)
    return out.reshape(temp.shape)


def apply_convection(
    temp: torch.Tensor, buckets: ConvectionBuckets, keys: torch.Tensor
) -> torch.Tensor:
    """Randomly mixes CV temperatures within each room of a (B, H, W)
    batch with per-env (B, 2) step keys; non-room CVs untouched. Both
    methods apply a permutation, so room multisets are preserved exactly."""
    if not buckets.enabled:
        return temp
    dev = temp.device
    if buckets.method == "swap":
        plane = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)
        word = swap_decision_word(buckets, keys, tuple(temp.shape[-2:]))
        return apply_swaps_with_word(
            temp, buckets.offsets, plane(buckets.lead_words),
            plane(buckets.foll_words), word,
        )
    return apply_argsort(
        temp,
        torch.as_tensor(buckets.flat_indices.astype(np.int64), device=dev),
        torch.as_tensor(buckets.segment_keys, device=dev),
        keys,
    )
