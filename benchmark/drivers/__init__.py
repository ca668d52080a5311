"""One general generator per kind of traffic, found by the ``driver`` a
traffic file names. Each module has ``Cell(ctx[, program])`` with
``setup()``, ``window(seconds, hooks)``, ``check()`` and ``close()``.

``window`` runs whole units back to back, calls ``hooks.start()`` just
before the first and ``hooks.end()`` just after the last, and returns
``attempted``, ``failed`` and the cell's end-to-end values (``e2e``);
``check`` returns each number compared as ``name: (value, limit)``;
``reference_s`` holds the seconds ``setup()`` spent in the plain
reference, which ``setup_s`` leaves out.
``program`` stands in for the driver's timed call into the port (the
tests' faults); ``ctx.control`` puts the reference's control there.
"""
