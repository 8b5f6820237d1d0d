"""The repository's tools, ported: each module is the counterpart of the
file of the same name under ``tools/`` and runs as
``python -m ocrs_tpu_torch.tools.<name>``.

  * ``eval_accuracy``: word-level precision, recall and F1 of the engine on
    styled pages, with best-IoU matching;
  * ``eval_independent``: the engine on pages drawn by matplotlib, pygame
    and a face outside the training bank;
  * ``test_e2e``: the golden tier of the CLI with the fake models;
  * ``imgrep``: search for text in images;
  * ``soup``: average weight files;
  * ``gen_golden``: draw the golden pages of the CLI tier;
  * ``profile_stages``: fenced times of the page pipeline's sub-operations.

Each keeps its JAX counterpart's flags, defaults, output and exit codes, and
adds ``--device`` (CUDA unless the CPU is asked for; there is no fallback)
and, where it draws pages, ``--pages-from FILE``: a page file of
``test-data/eval/`` (made by ``tools/torch_eval_fixtures.py``), so that a
machine that cannot draw reads the same pages. Pages are drawn only inside
the functions that draw; where Pillow, matplotlib, pygame or a face is
missing they raise :class:`ocrs_tpu_torch.train.render.RenderUnavailable`.
"""
