// ABI handshake for the native library of cfd_proxy (partition.cc: RCB and
// ghost closure; golden.cc: the C golden sweep).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

extern "C" {

// Bump whenever ANY exported signature in this library changes.  The ctypes
// loader (cfd_proxy/native/__init__.py::_bind) refuses a library whose
// version differs from its expected constant, so a stale in-tree .so fails
// the handshake and flows into the rebuild-via-temp-copy path instead of
// being called with a mismatched argument list (silent heap corruption).
int cfd_abi_version(void) { return 5; }

}  // extern "C"
