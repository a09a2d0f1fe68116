"""Host-side data layer of the port: audio IO, corpora, batching, staging
on the device (numpy on the host, as in the JAX package)."""

from titanet_torch.data.audio_io import read_audio, read_wav, write_wav  # noqa: F401
from titanet_torch.data.dataset import (  # noqa: F401
    DATASETS,
    ConcatSpeakerDataset,
    LibriSpeechDataset,
    SpeakerDataset,
    Subset,
    SyntheticSpeakerDataset,
    VCTKDataset,
    VoxCelebDataset,
    get_datasets,
)
from titanet_torch.data.loader import (  # noqa: F401
    Batch,
    ChunkConfig,
    DataLoader,
    NoiseMixConfig,
    ReverbConfig,
    SpeedConfig,
    default_buckets,
    device_prefetch,
)
