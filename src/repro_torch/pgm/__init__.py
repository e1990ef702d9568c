"""PGM substrate: model IR, coloring, compiler chain, diagnostics."""
