"""tile_coding_ms.ra: StageTimer ``encode_tiles`` less ``plan`` (the native tile coder and
its host walk; ``plan`` runs inside ``encode_tiles`` on the same thread),
ms per picture coded in the window, in random access."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("encode_tiles", "plan"))
