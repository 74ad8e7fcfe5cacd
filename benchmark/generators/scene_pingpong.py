"""The generator ``scene_pingpong``: the ``scene`` generator's ring walked
forth and back, for a system that carries state from frame to frame.

The ring's first half and one frame more (frames 0 to n/2 of the scene's
pan) is drawn, then walked back (n/2 − 1 down to 1), so that cycling
through the ring turns the pan round at each end instead of jumping back
by the whole pan, which a motion estimate would see as a cut. Every seed
gives the same sizes, disparities and motion.

The scene's disparities are fractions of the mix's ``disparity_range_px``
(full-resolution pixels at the configuration's rig size), since a fused
configuration searches at a processing scale of its own.
"""

from __future__ import annotations

from benchmark.generators import scene


def inputs(config: dict, traffic: dict, seed: int, device):
    s = traffic["scene"]
    half = int(s["ring_frames"]) // 2
    forth = dict(traffic, scene=dict(s, ring_frames=half + 1))
    rig = {"rig": config["rig"],
           "pipeline": {"params": {"num_disparities": s["disparity_range_px"]}}}
    frames = scene.inputs(rig, forth, seed, device)
    return frames + frames[-2:0:-1]
