"""``python -m lightgbm_tpu_torch`` — the CLI entry point (port of
``lightgbm_tpu/__main__.py``; LightGBM src/main.cpp:11).  Tasks: train /
predict / refit / convert_model via ``key=value`` args, and the
profiling verb ``python -m lightgbm_tpu_torch profile config=train.conf``
(a ``torch.profiler`` capture), the serving verb ``serve model.txt`` and
the fleet verb ``serve-fleet model.txt workers=N``.  The reference's lint
verbs raise ``NotImplementedError`` naming ROADMAP queue 1 item 12."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
