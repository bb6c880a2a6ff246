// Stands in for the CUDA header on the host (testing/host_cuda.h).
#pragma once
#include "host_cuda.h"
