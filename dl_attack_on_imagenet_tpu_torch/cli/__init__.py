"""CLI entry points: ``cli.main`` (attack one image, draw the figure) and
``cli.demo`` (the whole experiment)."""
