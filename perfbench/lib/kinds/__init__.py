"""Traffic drivers, one module a traffic ``kind``. Each has:

* ``setup(run)``: make the inputs from the seed, build what the program
  builds, and warm up this cell's shapes (all set-up);
* ``window(run, seconds)``: drive the traffic back to back from the
  window's start, finish the unit (session, batch, round) that runs when
  ``seconds`` elapse, and record it;
* ``release(run)``: free the program's state, keeping the records;
* ``judge(run, precision)``: the numbers that decide ``correct``, with
  the reference in the program's place in ``precision`` when it is not
  the reference's own (the control);
* ``end_to_end(run)``: the cell's end-to-end metrics besides
  ``setup_s``.

``run`` is a :class:`perfbench.lib.runner.Run`.
"""
