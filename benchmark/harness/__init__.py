"""The benchmark's harness: it finds a cell's configuration, traffic mix,
limits and metric readers by name, drives the port's trainer through a
set-up, a measured window and an optional traced epoch, and checks the
trainer's first epochs against the plain reference."""
