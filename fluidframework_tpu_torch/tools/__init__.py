"""Developer tooling: replay CLI, benchmark harness (SURVEY.md §2.4 —
replay-tool / fluid-runner / @fluid-tools/benchmark capability)."""
