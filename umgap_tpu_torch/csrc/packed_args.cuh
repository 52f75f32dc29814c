// The argument block kernels.Kernel.launch passes to each C entry's
// `*_packed` twin: one 8-byte slot per argument, integers and pointers
// as int64, floats as double (struct.pack in Python). One pointer
// crosses ctypes instead of a dozen converted arguments.
#pragma once

#include <stdint.h>
#include <string.h>

struct PackedArgs {
  const unsigned char* p;
  long long i(int k) const {
    long long v;
    memcpy(&v, p + 8 * k, 8);
    return v;
  }
  void* ptr(int k) const { return (void*)(intptr_t)i(k); }
  double d(int k) const {
    double v;
    memcpy(&v, p + 8 * k, 8);
    return v;
  }
};
