from repro_torch.optim.sgd import sgd_init, sgd_update
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.optim.schedules import step_decay, warmup_cosine

OPTIMIZERS = {"sgd": (sgd_init, sgd_update), "adam": (adam_init, adam_update)}


def get_optimizer(name: str):
    return OPTIMIZERS[name]
