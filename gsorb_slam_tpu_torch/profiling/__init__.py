"""The port's profilers, one module per ``scripts/profile_*.py`` of the JAX
package and under its name: ``python -m gsorb_slam_tpu_torch.profiling.<name>``
runs one on the card (``--cpu``: on the CPU, with the plain versions). Each
module's ``main(argv)`` returns its numbers as a dict."""
