"""Loop closing: the keyframe BoW index that serves relocalization.

Port of part of `orb_slam2_refactored_tpu/slam/loop_closing.py`: the
`LoopCloser` state that the tracker keeps whether or not loop closing is on
(the place-recognition database, the consistency groups, the loop
cooldowns) and `add_keyframe_bow`, which indexes a keyframe and refits the
idf every 8 indexed keyframes. Detection, the Sim3 solve, the correction
and global BA are not ported yet; the tracker refuses
`enable_loop_closing=True` at construction, so nothing here stands in for
them.
"""

from __future__ import annotations

from typing import List

from .map_state import MapArrays
from .vocabulary import KeyFrameDatabase, Vocabulary


class LoopCloser:
    def __init__(self, voc: Vocabulary, kf_capacity: int,
                 fix_scale: bool = True):
        self.db = KeyFrameDatabase(voc, kf_capacity)
        # stereo/RGB-D: the Sim3 scale is fixed to 1
        self.fix_scale = fix_scale
        # consistency groups: list of (set_of_kfs, count)
        self.consistent_groups: List = []
        self.last_loop_kf = -1
        # cooldowns compare creation sequence numbers (graph.kf_seq), not
        # slot indices: slots are recycled on long sequences
        self.last_loop_seq = -1
        self.loops_closed = 0
        self._n_indexed = 0

    def add_keyframe_bow(self, m: MapArrays, kf: int):
        """Compute and store the BoW row of keyframe `kf` (ComputeBoW);
        refit the idf to the live corpus every 8 indexed keyframes (the
        reference's idf comes with ORBvoc.txt; a live-trained vocabulary
        tracks its own document frequencies). No host read."""
        v, _ = self.db.compute_bow(m.kf_desc[kf], m.kf_feat_valid[kf])
        self.db.add(kf, v)
        self._n_indexed += 1
        if self._n_indexed % 8 == 0:
            self.db.refit_idf()
        return v
