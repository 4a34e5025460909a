"""Shot/Survey descriptions and shape bucketing (port of
`repro.survey.shots`, unchanged: numpy only; DESIGN.md §6).

A shot is one independent propagate: its own sparse off-the-grid sources
(with per-source wavelets) and receivers over the survey's shared model.
Shot geometries vary — 3 sources here, 5 there — but every distinct
(nsrc, nrec) pair would be a distinct set of traced shapes, and a
thousand-shot survey must not pay a thousand executable builds.  Bucketing
rounds both counts up to a bounded menu of padded shapes (powers of two
by default), so the number of compiled executables is O(log max_nsrc x
log max_nrec) regardless of survey size; the padding is realized with
ZERO-AMPLITUDE sources (silent — injection adds exact zeros) and
duplicated receivers (their trace rows are sliced off), so a padded shot
is bit-equivalent to the unpadded one.

The engine turns a bucket key (nsrc_pad, nrec_pad) into table caps by
multiplying with the interpolation footprint (2r)**3 from its
`interp.InterpSpec` — 8 for the default trilinear kernel, 512 for a
radius-4 Kaiser-windowed sinc — so bucket shapes also depend on the
survey's interpolation order (see `survey/engine.SurveyEngine._caps`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Shot:
    """One shot: sources with wavelets, receivers, over the shared model.

    src_coords: (nsrc, ndim) physical (off-the-grid) source positions.
    wavelet:    (nt, nsrc) per-source time signatures.
    rec_coords: (nrec, ndim) physical receiver positions.
    shot_id:    stable identifier carried through to the result.
    """

    src_coords: np.ndarray
    wavelet: np.ndarray
    rec_coords: np.ndarray
    shot_id: int = 0

    def __post_init__(self):
        object.__setattr__(self, "src_coords",
                           np.atleast_2d(np.asarray(self.src_coords,
                                                    np.float64)))
        object.__setattr__(self, "rec_coords",
                           np.atleast_2d(np.asarray(self.rec_coords,
                                                    np.float64)))
        object.__setattr__(self, "wavelet",
                           np.asarray(self.wavelet, np.float64))
        if self.wavelet.ndim != 2 or \
                self.wavelet.shape[1] != self.src_coords.shape[0]:
            raise ValueError(
                f"wavelet must be (nt, nsrc={self.src_coords.shape[0]}), "
                f"got {self.wavelet.shape}")

    @property
    def nsrc(self) -> int:
        return self.src_coords.shape[0]

    @property
    def nrec(self) -> int:
        return self.rec_coords.shape[0]

    @property
    def nt(self) -> int:
        return self.wavelet.shape[0]

    def padded(self, nsrc: int, nrec: int) -> "Shot":
        """Pad to a bucket shape: extra sources duplicate the first source
        position with all-zero wavelets (inject exact zeros); extra
        receivers duplicate the first receiver position (their rows are
        discarded by the engine's `nrec` slice)."""
        if nsrc < self.nsrc or nrec < self.nrec:
            raise ValueError(f"cannot pad ({self.nsrc}, {self.nrec}) down "
                             f"to ({nsrc}, {nrec})")
        if nsrc == self.nsrc and nrec == self.nrec:
            return self
        src = np.concatenate(
            [self.src_coords,
             np.repeat(self.src_coords[:1], nsrc - self.nsrc, axis=0)])
        wav = np.concatenate(
            [self.wavelet, np.zeros((self.nt, nsrc - self.nsrc))], axis=1)
        rec = np.concatenate(
            [self.rec_coords,
             np.repeat(self.rec_coords[:1], nrec - self.nrec, axis=0)])
        return Shot(src_coords=src, wavelet=wav, rec_coords=rec,
                    shot_id=self.shot_id)


@dataclasses.dataclass(frozen=True)
class Survey:
    """An ordered shot list over one shared model.

    The engine takes the model (params dict) separately — a Survey is pure
    acquisition geometry, so the same Survey can replay over many models
    (FWI iterations reuse every cached plan and compiled bucket).
    """

    shots: Tuple[Shot, ...]

    def __post_init__(self):
        object.__setattr__(self, "shots", tuple(self.shots))
        if not self.shots:
            raise ValueError("a survey needs at least one shot")
        nts = {s.nt for s in self.shots}
        if len(nts) > 1:
            raise ValueError(f"all shots must share nt, got {sorted(nts)}")

    @property
    def nt(self) -> int:
        return self.shots[0].nt

    @property
    def num_shots(self) -> int:
        return len(self.shots)


def pad_count(n: int) -> int:
    """Bucket granularity: next power of two (1, 2, 4, 8, ...)."""
    if n < 1:
        raise ValueError("counts must be >= 1")
    return 1 << (n - 1).bit_length()


class ShotBucket:
    """Shots sharing one padded (nsrc, nrec) shape = one executable."""

    def __init__(self, key: Tuple[int, int]):
        self.key = key
        self.indices: List[int] = []
        self.shots: List[Shot] = []

    @property
    def nsrc(self) -> int:
        return self.key[0]

    @property
    def nrec(self) -> int:
        return self.key[1]

    def __len__(self):
        return len(self.shots)

    def __repr__(self):
        return (f"ShotBucket(nsrc={self.nsrc}, nrec={self.nrec}, "
                f"shots={len(self)})")


def bucket_shots(shots: Sequence[Shot]) -> Dict[Tuple[int, int], ShotBucket]:
    """Group shots by padded (nsrc, nrec); shots are padded into their
    bucket shape (ragged buckets carry zero-amplitude padding sources).

    Returns buckets in deterministic (sorted-key) order; each bucket
    remembers the original survey indices so results reassemble in shot
    order.
    """
    buckets: Dict[Tuple[int, int], ShotBucket] = {}
    for i, s in enumerate(shots):
        key = (pad_count(s.nsrc), pad_count(s.nrec))
        b = buckets.setdefault(key, ShotBucket(key))
        b.indices.append(i)
        b.shots.append(s.padded(*key))
    return dict(sorted(buckets.items()))
