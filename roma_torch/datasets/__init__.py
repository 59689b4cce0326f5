"""Training datasets (numpy/PIL, no torch): MegaDepth and ScanNet pairs, and
the weighted, threaded batch loader; copies of the JAX package's."""

from roma_torch.datasets.megadepth import MegadepthBuilder, MegadepthScene
from roma_torch.datasets.scannet import ScanNetBuilder, ScanNetScene
from roma_torch.datasets.loader import PairLoader, weighted_pair_iterator
