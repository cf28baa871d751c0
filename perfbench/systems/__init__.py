"""The drivers, one module a kind of system, found by the name a
configuration gives under ``"system"``. Each exposes
``Driver(config, traffic, device, program_hook=None, logs=False)`` with:

- ``span``: the name of the profiler span around each entry call;
- ``step_site``: the frame step as ``(owner, attribute)``, which the
  recorder wraps and the faults are planted in (``core/faults.py``);
- ``check``: the configuration's step comparison
  (``manifest.load_check``), whose ``take_state`` and ``keep_out`` build
  ``steps``, the ``check.CallRecorder`` over ``step_site``; it is built
  after ``program_hook(driver)`` has run;
- ``gts`` (each stream's ground truth) and ``next`` (the next frame);
- ``first()`` and ``call()``: one entry call, returning the keys handed
  in and the keys whose pose it returned (a key is (stream, frame id));
- ``arm(tag)``, ``open_window()``, ``close_window()``, ``close()``,
  ``trajectories()``, ``layer_logs()`` and ``release()``, as
  ``harness.execute`` uses them.
"""
