"""Live viewer: a background render loop over the running tracker.

Port of `orb_slam2_refactored_tpu/viz/viewer.py` (the reference's Pangolin
`Viewer` thread, `src/Viewer.cc:62-179`): a thread redraws the map
(`plot.plot_map`) into PNG files at a fixed rate while tracking runs, relays
the operator's commands from a control file to the system, and writes the
tracker's status.

It reads the tracker without stopping it. The graph's numpy mirrors and
the trajectory are host objects; the map's device arrays (`mp_pos`,
`mp_valid`, `kf_pose`) are read once a tick through `utils/readback.py::
Readback`, a pinned copy and an event on the stream: a tick renders the
copy started at an earlier tick once its event has completed, and starts
the next one. A `.cpu()` from this thread would wait for everything the
tracker has queued on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import traceback
from typing import Optional

from ..utils.readback import Readback


class LiveViewer:
    """Background thread rendering `plot_map` snapshots of a live tracker.

    Usage (`System::Viewer`, `src/System.cc:99-107`):
        viewer = LiveViewer(tracker, out_dir="viz_live", hz=1.0)
        viewer.start()
        ... track frames ...
        viewer.stop()

    Files: `out_dir/map_latest.png` (replaced atomically each tick: the
    "window"), a bounded history `map_00000.png ...`, `status.json`.
    """

    def __init__(self, tracker, out_dir: str = "viz_live", hz: float = 1.0,
                 keep_history: int = 20, system=None):
        self._tracker = tracker
        self.system = system  # the control surface and the live tracker
        self.out_dir = out_dir
        self.period = 1.0 / max(hz, 1e-3)
        self.keep_history = keep_history
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._read = None  # (tracker, {name: Readback}) in flight
        self.frames_rendered = 0
        self.commands_relayed = 0
        self.reads_not_landed = 0  # ticks whose map read had not landed
        self.failures = 0  # consecutive failed ticks
        self.render_ms = []  # host time of each rendered tick
        # (start, end, rendered) of every tick on `time.perf_counter`'s
        # clock, to tell the tracker's steps that overlapped one
        self.tick_spans = []

    @property
    def tracker(self):
        # through the system when attached: `SlamSystem.reset()` swaps the
        # tracker, and a pinned reference would render a dead map
        return self.system.tracker if self.system is not None else self._tracker

    # -- lifecycle (Viewer::RequestFinish) ---------------------------------

    def start(self):
        os.makedirs(self.out_dir, exist_ok=True)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="live-viewer",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_render: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if final_render:
            self._render_once(wait=True)
            self._write_status()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- render loop -------------------------------------------------------

    def _run(self):
        while not self._stop.wait(self.period):
            t0, n0 = time.perf_counter(), self.frames_rendered
            try:
                self._poll_control()
                self._render_once()
                self._write_status()
                self.failures = 0
            except Exception as e:
                # a torn snapshot mid-keyframe must not kill the viewer, but
                # a persistent failure must be diagnosable
                self.failures += 1
                if self.failures in (1, 10):
                    print(f"[live-viewer] render failed ({self.failures} "
                          f"consecutive): {e!r}", file=sys.stderr)
                    if self.failures == 10:
                        traceback.print_exc()
            self.tick_spans.append((t0, time.perf_counter(),
                                    self.frames_rendered > n0))

    # -- control surface (the reference viewer's menu: "Localization
    # Mode" and "Reset"; the transport is a `control` file in out_dir) ----

    def _poll_control(self):
        """Consume `out_dir/control` (a command a line, see
        `SlamSystem.request_command`) and relay it to the system, which
        applies it at its next tracked frame (`src/System.cc:221-308`)."""
        if self.system is None:
            return
        path = os.path.join(self.out_dir, "control")
        if not os.path.exists(path):
            return
        claimed = os.path.join(self.out_dir, ".control_consumed")
        try:
            # claim first by an atomic rename, then read: a read-then-remove
            # would delete a file the operator rewrote between the two
            os.replace(path, claimed)
            with open(claimed) as f:
                lines = f.read().splitlines()
            os.remove(claimed)
        except OSError:
            return  # the producer is mid-write; next tick
        for line in lines:
            parts = line.strip().split(None, 1)
            if not parts or parts[0].startswith("#"):
                continue
            self.system.request_command(parts[0],
                                        parts[1] if len(parts) > 1 else "")
            self.commands_relayed += 1

    def _write_status(self):
        """`out_dir/status.json`: the FrameDrawer's status text
        (`src/FrameDrawer.cc:30-90`): state and counts."""
        t = self.tracker
        lc = getattr(t, "loop_closer", None)
        status = {
            "frame_id": int(t.frame_id),
            "state": int(t.state),
            "keyframes": int(len(t.graph.alive_kfs())),
            "points": int(len(t.graph.alive_points())),
            "localization_only": bool(getattr(t, "localization_only", False)),
            "loops_closed": int(lc.loops_closed) if lc is not None else 0,
        }
        tmp = os.path.join(self.out_dir, ".status_tmp.json")
        with open(tmp, "w") as f:
            json.dump(status, f)
        os.replace(tmp, os.path.join(self.out_dir, "status.json"))

    def _map_arrays(self, t, wait: bool):
        """The map's (mp_pos, mp_valid, kf_pose) on the host from the read
        in flight if it has landed (and was of this tracker), else None;
        starts the next read. With `wait`, a read started now and waited
        for."""
        pending, self._read = self._read, None
        if pending is not None and pending[0] is not t:
            pending = None  # a reset swapped the tracker
        if pending is not None and not wait and not all(
                r.done() for r in pending[1].values()):
            self._read = pending  # keep waiting on it
            self.reads_not_landed += 1
            return None
        m = t.map
        read = {"mp_pos": Readback(m.mp_pos), "mp_valid": Readback(m.mp_valid),
                "kf_pose": Readback(m.kf_pose)}
        if wait:
            pending = (t, read)
        else:
            self._read = (t, read)
        if pending is None:
            return None
        return {n: r.result() for n, r in pending[1].items()}

    def _render_once(self, wait: bool = False):
        from .plot import plot_map

        t = self.tracker
        if t.state != 1 or len(t.graph.alive_kfs()) == 0:
            return
        arrays = self._map_arrays(t, wait)
        if arrays is None:
            return
        t0 = time.perf_counter()
        idx = self.frames_rendered
        tmp = os.path.join(self.out_dir, ".map_tmp.png")
        plot_map(t, tmp, title=f"tpu-slam live (frame {t.frame_id})",
                 **arrays)
        latest = os.path.join(self.out_dir, "map_latest.png")
        os.replace(tmp, latest)  # the atomic "window" update
        if self.keep_history > 0:
            shutil.copyfile(latest,
                            os.path.join(self.out_dir, f"map_{idx:05d}.png"))
            stale = os.path.join(self.out_dir,
                                 f"map_{idx - self.keep_history:05d}.png")
            if os.path.exists(stale):
                os.remove(stale)
        self.frames_rendered += 1
        self.render_ms.append((time.perf_counter() - t0) * 1e3)
