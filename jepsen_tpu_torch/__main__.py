"""``python -m jepsen_tpu_torch`` → the CLI (:mod:`.cli`).
(reference: project.clj:34 ``:main jepsen.cli``)"""

from .cli import main

if __name__ == "__main__":
    main()
