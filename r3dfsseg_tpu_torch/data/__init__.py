"""Host-side data pipeline (counterpart of `r3dfsseg_tpu/data/`): dataset
catalogs, episode samplers (clean and noise-injecting), augmentation, the
static test-episode cache and a prefetching episode loader that feeds the
device.  Numpy only; `loader.to_device` imports torch when it is called."""
from r3dfsseg_tpu_torch.data.catalogs import S3DISCatalog, ScanNetCatalog, get_catalog  # noqa: F401
from r3dfsseg_tpu_torch.data.sampler import sample_scan, augment_pointcloud  # noqa: F401
from r3dfsseg_tpu_torch.data.episodes import EpisodeSampler, NoisyEpisodeSampler, cut_out  # noqa: F401
from r3dfsseg_tpu_torch.data.cache import StaticTestDataset  # noqa: F401
from r3dfsseg_tpu_torch.data.loader import EpisodeLoader  # noqa: F401
