/* The null-point listing of a lattice receipt, built with the CPython API.
 *
 * `osc_null_listing(rows, n)` turns n packed records of four 32-bit words,
 * (i int32, j int32, z float32 bits, r float32 bits), into the list
 *
 *     [{"edge": [i, j], "z": z, "residual": r}, ...]
 *
 * in record order: the values `.tolist()` gives (int for i and j, the
 * double of each float32).  It is called through ctypes.PyDLL, so it holds
 * the interpreter lock throughout, and returns a new reference, or NULL with
 * a Python exception set.  It runs no bytecode, so the cyclic collector,
 * which Python 3.12 runs only between bytecodes, does not run while the
 * listing grows.
 *
 * Plain C, also valid C++ (the binding compiles it with $CXX). */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

/* One record as a new dict, or NULL with an exception set.  A new dict
 * holds five keys before it resizes, so the three inserts never resize. */
static PyObject *null_point(const int32_t *w, PyObject *k_edge, PyObject *k_z,
                            PyObject *k_r)
{
    float z, r;
    PyObject *d = NULL, *edge = NULL, *v = NULL;

    memcpy(&z, w + 2, sizeof z);
    memcpy(&r, w + 3, sizeof r);
    if (!(edge = PyList_New(2)))
        goto fail;
    if (!(v = PyLong_FromLong((long)w[0])))
        goto fail;
    PyList_SET_ITEM(edge, 0, v); /* steals v */
    if (!(v = PyLong_FromLong((long)w[1])))
        goto fail;
    PyList_SET_ITEM(edge, 1, v);
    v = NULL;
    if (!(d = PyDict_New()) || PyDict_SetItem(d, k_edge, edge) < 0)
        goto fail;
    Py_CLEAR(edge);
    if (!(v = PyFloat_FromDouble((double)z)) || PyDict_SetItem(d, k_z, v) < 0)
        goto fail;
    Py_CLEAR(v);
    if (!(v = PyFloat_FromDouble((double)r)) || PyDict_SetItem(d, k_r, v) < 0)
        goto fail;
    Py_DECREF(v);
    return d;
fail:
    Py_XDECREF(v);
    Py_XDECREF(edge);
    Py_XDECREF(d);
    return NULL;
}

PyObject *osc_null_listing(const int32_t *rows, Py_ssize_t n)
{
    PyObject *out = NULL;
    PyObject *k_edge = PyUnicode_InternFromString("edge");
    PyObject *k_z = PyUnicode_InternFromString("z");
    PyObject *k_r = PyUnicode_InternFromString("residual");

    if (!k_edge || !k_z || !k_r || !(out = PyList_New(n)))
        goto done;
    for (Py_ssize_t t = 0; t < n; t++) {
        PyObject *d = null_point(rows + 4 * t, k_edge, k_z, k_r);
        if (!d) {
            Py_CLEAR(out); /* the slots not yet filled are NULL */
            goto done;
        }
        PyList_SET_ITEM(out, t, d);
    }
done:
    Py_XDECREF(k_edge);
    Py_XDECREF(k_z);
    Py_XDECREF(k_r);
    return out;
}

#ifdef __cplusplus
}
#endif
