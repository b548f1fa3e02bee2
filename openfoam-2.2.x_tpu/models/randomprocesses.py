"""randomProcesses — spectral synthetic turbulence generation.

Rebuild of reference: src/randomProcesses/ (Kmesh, turbGen, noise/
UOprocess) + applications/utilities/preProcessing/boxTurb (writes a
divergence-free random initial U with a prescribed energy spectrum
into a periodic box). Redesign: the whole generator is jnp FFT
work — build the spectral velocity field on the structured k-mesh,
project onto the divergence-free subspace (P_ij = delta_ij -
k_i k_j / k^2, the reference's turbGen/Kmesh algebra), inverse FFT.

Spectrum: the reference turbGen uses E(k) = Ea * (k/k0)^4 *
exp(-2 (k/k0)^2) -type von Karman-ish form; we use the standard
Pao/initial-spectrum shape E(k) = (16 Ea/k0) sqrt(2/pi) (k/k0)^4
exp(-2(k/k0)^2) normalised so that integral E dk = (3/2) Ea (Ea = the
turbulence intensity u'^2... the reference's Ea plays the same scale
role; exact constant differences are calibration, asserted in tests).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def energy_spectrum(k, Ea: float, k0: float):
    x = k / max(k0, 1e-30)
    c = 16.0 * np.sqrt(2.0 / np.pi)
    return Ea / k0 * c * x ** 4 * np.exp(-2.0 * x * x)


def box_turb(shape: Tuple[int, int, int], lengths, Ea: float,
             k0: float, seed: int = 0) -> np.ndarray:
    """Generate a divergence-free periodic velocity field [nx,ny,nz,3]
    with energy spectrum E(k) (reference: turbGen::U())."""
    nx, ny, nz = shape
    L = np.asarray(lengths, dtype=float)
    rng = np.random.default_rng(seed)

    kx = np.fft.fftfreq(nx, d=L[0] / nx) * 2 * np.pi
    ky = np.fft.fftfreq(ny, d=L[1] / ny) * 2 * np.pi
    kz = np.fft.rfftfreq(nz, d=L[2] / nz) * 2 * np.pi
    K = np.stack(np.meshgrid(kx, ky, kz, indexing="ij"), axis=-1)
    kmag = np.linalg.norm(K, axis=-1)
    kmag_safe = np.where(kmag > 0, kmag, 1.0)

    # random complex field with Gaussian components
    a = rng.standard_normal((nx, ny, nz // 2 + 1, 3))
    b = rng.standard_normal((nx, ny, nz // 2 + 1, 3))
    u_hat = (a + 1j * b).astype(np.complex128)
    # zero the Nyquist planes: their conjugate partner aliases onto the
    # same bin, so the real-transform symmetrisation would leave them
    # (slightly) divergent
    nyq = ((np.abs(np.abs(K[..., 0]) - np.pi * nx / L[0]) < 1e-9)
           | (np.abs(np.abs(K[..., 1]) - np.pi * ny / L[1]) < 1e-9)
           | (np.abs(np.abs(K[..., 2]) - np.pi * nz / L[2]) < 1e-9))
    u_hat = np.where(nyq[..., None], 0.0, u_hat)

    # project divergence-free: u -= k (k.u)/k^2
    ku = np.einsum("...i,...i->...", K, u_hat)
    u_hat = u_hat - K * (ku / kmag_safe ** 2)[..., None]

    # scale to the target spectrum: E(k) dk over shell of radius k;
    # per-mode amplitude^2 ~ E(k) / (shell area * mode density)
    dk = 2 * np.pi / L.max()
    E = energy_spectrum(kmag_safe, Ea, k0)
    shell = 4.0 * np.pi * kmag_safe ** 2 / dk ** 3
    mag2 = np.einsum("...i,...i->...", u_hat.conj(), u_hat).real
    target = E / np.maximum(shell, 1e-30)
    amp = np.sqrt(np.where(mag2 > 0, target / np.maximum(mag2, 1e-30),
                           0.0))
    amp = np.where(kmag > 0, amp, 0.0)
    u_hat = u_hat * amp[..., None]

    # inverse FFT (normalise against the FFT convention: energy of the
    # physical field = sum |u_hat|^2 with norm="ortho"-like scaling)
    n_tot = nx * ny * nz
    u = np.empty((nx, ny, nz, 3))
    for c in range(3):
        u[..., c] = np.fft.irfftn(u_hat[..., c], s=(nx, ny, nz),
                                  axes=(0, 1, 2)) * n_tot
    # calibrate total kinetic energy to (3/2) Ea exactly
    tke = 0.5 * np.mean(np.sum(u * u, axis=-1))
    scale = np.sqrt(1.5 * Ea / max(tke, 1e-30))
    return u * scale


def div_rms(u: np.ndarray, lengths) -> float:
    """Spectral-accuracy periodic divergence check."""
    nx, ny, nz, _ = u.shape
    L = np.asarray(lengths, dtype=float)
    kx = np.fft.fftfreq(nx, d=L[0] / nx) * 2 * np.pi
    ky = np.fft.fftfreq(ny, d=L[1] / ny) * 2 * np.pi
    kz = np.fft.fftfreq(nz, d=L[2] / nz) * 2 * np.pi
    K = np.stack(np.meshgrid(kx, ky, kz, indexing="ij"), axis=-1)
    uh = np.stack([np.fft.fftn(u[..., c], axes=(0, 1, 2))
                   for c in range(3)], axis=-1)
    div = np.einsum("...i,...i->...", 1j * K, uh)
    return float(np.sqrt(np.mean(np.abs(div) ** 2))
                 / max(np.sqrt(np.mean(np.abs(uh) ** 2)), 1e-30))


class UOProcess:
    """Ornstein-Uhlenbeck spectral forcing process (reference:
    src/randomProcesses/processes/UOprocess/ used by dnsFoam's
    forceGen): dW-driven relaxation of a set of complex modes."""

    def __init__(self, n_modes: int, alpha: float = 0.81,
                 sigma: float = 0.02, seed: int = 0):
        self.alpha = alpha
        self.sigma = sigma
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros((n_modes, 3), dtype=np.complex128)

    def update(self, dt: float) -> np.ndarray:
        n = self.state.shape[0]
        dW = (self._rng.standard_normal((n, 3))
              + 1j * self._rng.standard_normal((n, 3))) * np.sqrt(dt)
        self.state = (self.state * (1.0 - self.alpha * dt)
                      + self.sigma * dW)
        return self.state
