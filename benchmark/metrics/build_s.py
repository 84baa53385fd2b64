"""Seconds of the engine's offline build: ``offline(device=True)`` and
``build_index(table=True)``, the card synchronised after (host clock,
the harness's span)."""


def read(run):
    return run.setup.get("build_s")
