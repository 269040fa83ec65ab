from repro_torch.sharding.partition import (P, batch_specs, cache_specs,
                                            dense_param_specs, from_blocks,
                                            local_block, state_specs,
                                            to_placements)
