"""The port's layers as the program's stage names spell them.

Each layer is a set of stage names (`hite_tpu_torch.utils.log.STAGE_TIMES`,
host clock, not synchronised with the device), summed over the window.
The copy join runs inside the modules' stages, so it is not a top-level
layer: the top-level layers and `other` add up to the passes.
"""

from __future__ import annotations

from typing import Dict, Tuple

# layer -> (exact stage names, stage-name suffixes)
LAYERS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "discovery": (("pipeline.tandem_mask", "pipeline.coarse"), ()),
    "modules": (("pipeline.modules", "pipeline.low_copy_rescue"), ()),
    "copy_join": (("pipeline.gindex",),
                  (".copies", ".alt_copies", ".ba_fetch")),
    "ltr": (("pipeline.ltr",), ()),
    "library": (("pipeline.library", "pipeline.domain", "pipeline.clean"),
                ()),
    "annotate": (("pipeline.annotate", "pipeline.write_outputs"), ()),
}
TOP_LEVEL = ("discovery", "modules", "ltr", "library", "annotate")


def stage_seconds(stage_times: Dict[str, float], layer: str) -> float:
    exact, suffixes = LAYERS[layer]
    return sum(v for k, v in stage_times.items()
               if k in exact or (suffixes and k.endswith(suffixes)))


def per_mbp(ctx: dict, layer: str):
    """The layer's seconds per Mbp of genome over the window; None when no
    stage of it ran."""
    st = ctx["stage_times"]
    exact, suffixes = LAYERS[layer]
    if not any(k in exact or (suffixes and k.endswith(suffixes))
               for k in st) or not ctx["mbp"]:
        return None
    return stage_seconds(st, layer) / ctx["mbp"]
