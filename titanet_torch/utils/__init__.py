"""Utilities of the port: seeding, the loggers (:mod:`.logging`,
:mod:`.tb_events`), the JAX weight bridge (:mod:`.weights`), figures
(:mod:`.viz`), profiling (:mod:`.profiling`), export (:mod:`.export`) and
downloads (:mod:`.download`)."""

import torch

from titanet_torch.utils.logging import (  # noqa: F401
    ConsoleLogger,
    JsonlLogger,
    StepTimer,
    TensorBoardLogger,
    WandbLogger,
)


def set_seed(seed: int) -> torch.Generator:
    """Global seeding (reference set_seed, src/utils.py:281-291): Python's
    ``random``, numpy's global generator and torch's on every device (what
    initializes modules when no generator is passed). Returns a CPU
    ``torch.Generator`` seeded with ``seed``: the port's randomness is
    drawn from explicit generators, as the JAX package's from explicit
    keys."""
    import os
    import random

    import numpy as np

    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def chart_dependencies(model, n_mels: int = 80, seed: int = 0) -> bool:
    """Backprop batch-independence check (reference chart_dependencies,
    src/utils.py:451-468): one batch element's output has zero gradient
    with respect to every other element's input, in eval mode."""
    import numpy as np

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    batch_size = int(rng.integers(2, 10))
    time_steps = int(rng.integers(10, 100))
    x = torch.tensor(rng.standard_normal((batch_size, time_steps, n_mels)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    target = int(rng.integers(0, batch_size))
    model.eval()
    (g,) = torch.autograd.grad(model(x)[target].float().sum(), x)
    g = g.cpu().numpy()
    others = np.delete(g, target, axis=0)
    assert (others == 0).all() and np.abs(g[target]).max() > 0, (
        f"Only index {target} should have non-zero gradients"
    )
    return True
