"""Mean decode steps the window's rollouts ran (the fused step's
``rollout_steps``): ``max_length`` unless every row ended early and the
chunked early exit stopped the rollout."""


def read(run):
    got = [v["rollout_steps"] for v in run.values if "rollout_steps" in v]
    return sum(got) / len(got) if got else None
