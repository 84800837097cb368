"""Training side of the port: the loss, the :class:`~.engine.Engine`
(train, eval and inference steps), checkpoints both ways (the JAX
package's ``.npz`` and the port's full train states), the trainer CLI
(``python -m deepi2p_tpu_torch.train.cli``) and the ``MMClassifier``
facade."""
