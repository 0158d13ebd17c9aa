"""The timed paths, one module per kind of traffic: a cell file's `runner`
names `benchmark/runners/<runner>.py`, whose `Runner` does the set-up, the
window's call, the units a trace profiles, and the check against the
reference (`harness.load_runner`)."""
