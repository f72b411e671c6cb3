from repro_torch.optim.sgd import sgd_init, sgd_update
