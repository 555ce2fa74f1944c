"""Public kernel entry points, mirroring ``repro.kernels.ops``.

Only the k-means pair is ported so far; the model kernels (flash
attention, WKV6, RG-LRU) come with the model slice of the port.  The
tensor's device picks the route (see ``repro_torch.kernels.kmeans``), so
there is no ``interpret`` switch here.
"""
from __future__ import annotations

from repro_torch.kernels.kmeans import kmeans_assign, kmeans_lloyd_step

__all__ = ["kmeans_assign", "kmeans_lloyd_step"]
