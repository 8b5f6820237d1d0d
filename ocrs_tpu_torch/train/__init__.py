"""Training on one GPU: the port of ``ocrs_tpu.train`` without the mesh.

:mod:`.losses` (BCE + soft Dice, mean CTC), :mod:`.optim` (the optax
recipes the repository trains with, on ``torch.optim``), :mod:`.train`
(train states and steps for the recognizers and the detector),
:mod:`.checkpoint` (``step-N.npz`` in the JAX package's layout, readable by
either package), :mod:`.pixelfont` (the bitmap face, numpy only) and
:mod:`.demo` (``python -m ocrs_tpu_torch.train.demo``).
"""
