"""The port's frontend package. So far it holds only the ctypes binding of
the native host library (``native/gsorb_native.cpp``); the ORB frontend
comes with its own slice."""
