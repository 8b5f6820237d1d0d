"""The port's trainer against tools/train_models.py for ConvCTC (dim 32,
the shipped architecture's five blocks), as tests/test_torch_train_models.py
holds them for the CRNN: one shared cache and ``--init-from`` file; flags,
batches and export exactly, step-1 loss and parameters after 2 steps by
the bf16 criteria. A file of its own keeps each under 30 s on the CPU."""

import torch

from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from tests.test_torch_train_models import cheap_jax_init, check_recognition_scripts  # noqa: F401


def test_convctc_scripts_agree(tmp_path, capsys, cheap_jax_init):
    model = RecognitionModel(None, "convctc", hidden=32, generator=torch.Generator().manual_seed(3))
    check_recognition_scripts(tmp_path, capsys, "convctc", model)
