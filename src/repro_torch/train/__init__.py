"""Training and serving substrate of the port: the optimizer, data,
checkpoints, the restartable loop, int8 gradient compression, the train
step, and the continuous-batching ``BatchedServer``
(:mod:`repro_torch.train.serve`)."""
from . import checkpoint, compression, data, ft, optimizer, serve, trainer  # noqa: F401
from .optimizer import OptConfig                                            # noqa: F401
from .trainer import TrainState, init_train_state, make_train_step         # noqa: F401
