from .y4m import Y4MReader, Y4MWriter, read_yuv_frames
from .ivf import IvfWriter, IvfReader

__all__ = ["Y4MReader", "Y4MWriter", "read_yuv_frames", "IvfWriter", "IvfReader"]
