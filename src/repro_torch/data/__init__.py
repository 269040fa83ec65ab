from repro_torch.data.ctr import CTRDataset, CTR_BENCHMARKS, make_ctr_dataset
