"""The timed calls, one module per kind, found by the
``entry`` of a traffic file. ``build(ctx)`` makes the program's object
and the inputs from the seed, and returns a cell with:

- ``waited``: whether the caller waits for each answer;
- ``work``: counts of work per call, read by ``window_rate``;
- ``stages``: the spreads and interps of one call (``roofline.Stage``),
  counted from the problem's sizes alone;
- ``warmup()``, ``call(i)`` (request i, its answer) and ``release()``
  (frees the program's state once the window has closed);
- ``answers(kept)``: (pool index, sampled entries) of each kept answer;
  ``control(n)``: the same entries of pool entries 0..n-1 computed by
  the reference in TF32, in the program's place; ``judge(p, entries)``:
  each compared number of one answer, taken against the float64
  reference of pool entry p.
"""
