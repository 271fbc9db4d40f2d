"""Model families: one module a family, ``families/<name>.py``, which a
configuration file names by its ``family`` key (``cfpnet`` where it names
none; ``spec.py``). The drivers (``drivers.py``) and ``run.py`` know no model:
they call these names of the cell's family module. A family whose cells are
all of one driver needs only that driver's names. ``tiny`` asks for the
family's test widths (CPU tests only); ``driver`` is ``"frames"`` or
``"train"``.

Both drivers, and ``run.py``:

- ``inputs(settings, driver, n, seed) -> {name: numpy array}``: ``n`` items
  of the driver's inputs, made from the seed; the same seed gives the same
  arrays, and every seed the same shapes;
- ``init_state(settings, seed, device, tiny) -> state dict``: the seeded
  weights, made on ``device`` (``weights.draw``), loaded by the port's model
  and by the reference alike;
- ``work(settings, traffic) -> (operations, kernel calls)``: of one traced
  item of the mix, counted on the reference; the calls as ``(kernel,
  shape)`` for the rooflines' readers.

``frames``:

- ``SERVED``: the names of the inputs that a frame serves, in the forward's
  order; ``HOST_OUTPUTS``: how many of the forward's first outputs are
  copied back to the host and judged;
- ``frame_model(settings, state, dtype, device, tiny)``: the port's model in
  the cell's dtype;
- ``capture_frames(model, settings, batch, tiny) -> forward``: the timed
  call, ``forward(*served) -> outputs``;
- ``frame_reference(settings, state, dtype, device, tiny) -> forward``: the
  plain reference in ``dtype``, called on the same inputs;
- ``frame_gaps(got, want, same) -> {number: gap}``: the port's outputs
  (``got``) against the float32 reference's (``want``), with the
  reference's in the cell's dtype (``same``, empty for float32) beside them.

``train``:

- ``train_program(settings, state, traffic, device, tiny) -> (model,
  optimizer state, step)``: ``step(optimizer state, batch, seed) -> loss``;
- ``first_gradient(optimizer state, settings) -> {parameter: norm}``: the
  first gradient's norm by parameter, read from the optimizer's state after
  one step (for AdamW: the first moment over 1 - b1);
- ``reference_steps(settings, state, batches, seeds, device, tiny)``: the
  reference's steps from the same weights, ``losses`` and the first
  gradient's and the change's norms by parameter (``grads``, ``change``).
"""
