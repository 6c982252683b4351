"""Plain versions that decide ``correct``: plain PyTorch in f32 with TF32 off.  This
package imports nothing of the program and takes nothing the program made."""
