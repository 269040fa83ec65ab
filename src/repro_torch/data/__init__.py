from repro_torch.data.ctr import CTRDataset, CTR_BENCHMARKS, make_ctr_dataset
from repro_torch.data.lm import lm_batches
