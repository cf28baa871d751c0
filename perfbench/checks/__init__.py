"""The step comparisons that decide ``correct``, one module a kind of
frame step, found by the name a configuration gives under
``"step_check"``. Each exposes:

- ``take_state(args, kwargs) -> dict``: the program's state a checked
  call of the frame step was handed, cloned before the call runs, with
  the handed pose under ``"R"`` and ``"t"`` (the pose faults of
  ``core/faults.py`` return it);
- ``keep_out(out) -> dict``: what the call returned that the comparison
  judges, cloned;
- ``compare(samples, stacks, config, readings, control)``: every kept
  ``(tag, state, output)`` against the plain reference, once the window
  has closed and the program is released; it adds its numbers to
  ``readings`` (and, with a control, to ``control``).
"""
