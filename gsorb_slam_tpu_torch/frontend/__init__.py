"""The port's geometric frontend (counterpart of ``gsorb_slam_tpu/frontend/``):
ORB extraction, descriptor matching, bundle adjustment, PnP and Sim3
RANSAC, triangulation, the BoW vocabulary, and the ctypes binding of the
native host library."""
