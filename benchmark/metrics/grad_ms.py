"""Mean device milliseconds of the CST step's grad phase over the
window's steps: the program's CUDA events at the fused step's phase
boundaries (``training/trainer.py::PhaseMarks``)."""

PHASE = "grad"


def read(run):
    got = [p[PHASE] for p in run.phases if PHASE in p]
    return sum(got) / len(got) if got else None
