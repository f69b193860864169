#include "emulate.h"
