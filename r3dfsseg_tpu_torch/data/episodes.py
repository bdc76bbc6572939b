"""Episode samplers: clean meta-train/test and noise-injecting variants
(counterpart of `r3dfsseg_tpu/data/episodes.py`, line for line).

Re-design of `MyDataset` (`dataloaders/loader.py:377-560`)
and `NoiseInMetaTest` (`loader.py:562-890`):

  * clean episodes: per way, k_shot+n_queries scans drawn from class2scans
    with an episode-wide blacklist;
  * noisy episodes: num_noise_shot = round(k_shot * ratio) shots per way are
    drawn from *other* classes but masked as if they were the target class;
    noise class ranges — 'sym' (in-episode ways), 'ood' (test classes minus
    ways), 'train' (all train classes, per-episode ratio drawn from a list),
    'partial' (same class, object-level mask corruption);
  * per-way shot-order shuffle, noisy shots' gt masks zeroed, support_flag
    carries each shot's absolute class (loader.py:794-851).

Everything produces channels-last `Episode`s of numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from r3dfsseg_tpu_torch.data.catalogs import get_catalog
from r3dfsseg_tpu_torch.data.sampler import load_scan, sample_k_scans
from r3dfsseg_tpu_torch.models.episode import Episode


class EpisodeSampler:
    """Clean episodes (MyDataset, loader.py:377-560)."""

    def __init__(self, data_path: str, dataset_name: str, *, cvfold: int = 0,
                 n_way: int = 2, k_shot: int = 5, n_queries: int = 1,
                 mode: str = "train", num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", pc_augm: bool = False,
                 pc_augm_config: Optional[Dict] = None,
                 seed: Optional[int] = None):
        self.data_path = data_path
        self.n_way, self.k_shot, self.n_queries = n_way, k_shot, n_queries
        self.num_point = num_point
        self.pc_attribs = pc_attribs
        self.pc_augm = pc_augm
        self.pc_augm_config = pc_augm_config
        self.catalog = get_catalog(dataset_name, cvfold, data_path)
        if mode == "train":
            self.classes = np.asarray(self.catalog.train_classes)
        elif mode == "test":
            self.classes = np.asarray(self.catalog.test_classes)
        else:
            raise NotImplementedError(f"Unknown mode {mode}! [Options: train/test]")
        self.mode = mode
        self.class2scans = self.catalog.class2scans
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def sample(self, n_way_classes: Optional[Sequence[int]] = None) -> Episode:
        if n_way_classes is not None:
            sampled = np.asarray(n_way_classes)
        else:
            sampled = self.rng.choice(self.classes, self.n_way, replace=False)
        return self._episode(sampled)

    def _episode(self, sampled_classes: np.ndarray) -> Episode:
        rng = self.rng
        sup_x, sup_y, q_x, q_y = [], [], [], []
        gt_sup, gt_q = [], []
        blacklist: list = []
        for cls in sampled_classes:
            names = [s for s in self.class2scans[int(cls)] if s not in blacklist]
            pick = rng.choice(names, self.k_shot + self.n_queries, replace=False)
            blacklist.extend(pick)
            q_names, s_names = pick[:self.n_queries], pick[self.n_queries:]
            qp, ql, qg, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, q_names,
                sampled_class=int(cls), sampled_classes=sampled_classes,
                is_support=False, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)
            sp, sl, sg, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, s_names,
                sampled_class=int(cls), sampled_classes=sampled_classes,
                is_support=True, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)
            q_x.append(qp); q_y.append(ql); gt_q.append(qg)
            sup_x.append(sp); sup_y.append(sl); gt_sup.append(sg)
        return Episode(
            support_x=np.stack(sup_x).astype(np.float32),
            support_y=np.stack(sup_y).astype(np.int32),
            query_x=np.concatenate(q_x).astype(np.float32),
            query_y=np.concatenate(q_y).astype(np.int32),
            gt_support_y=np.stack(gt_sup).astype(np.int32),
            gt_query_y=np.concatenate(gt_q).astype(np.int32),
            support_flag=np.tile(sampled_classes[:, None],
                                 (1, self.k_shot)).astype(np.int32),
            sampled_classes=sampled_classes.astype(np.int32),
        )


class NoisyEpisodeSampler(EpisodeSampler):
    """Noise-injecting episodes (NoiseInMetaTest, loader.py:562-890)."""

    def __init__(self, data_path: str, dataset_name: str, *,
                 noise_ratio, noise_type: str = "sym", mode: str = "train",
                 noise_pair: Optional[Dict[int, int]] = None, **kw):
        super().__init__(data_path, dataset_name, mode=mode, **kw)
        self.noise_ratio = noise_ratio
        # meta-training always uses 'train' noise with a per-episode ratio
        # drawn from a list (loader.py:584-587,668-671)
        self.noise_type = "train" if mode == "train" else noise_type
        # class -> confusion partner for 'pair' noise (the reference's
        # noise_pair_dict, commented out at loader.py:592-593 — 'pair'
        # crashes there; here the dict is an explicit argument)
        self.noise_pair = noise_pair
        if self.noise_type == "pair":
            if not noise_pair:
                raise ValueError("noise_type='pair' needs a noise_pair dict "
                                 "(class -> confusion partner)")
            missing = [int(c) for c in self.classes
                       if int(c) not in noise_pair]
            if missing:
                raise ValueError(
                    f"noise_pair dict is missing classes {missing} "
                    f"(must cover every {mode} class: "
                    f"{[int(c) for c in self.classes]})")
        if mode == "train":
            assert isinstance(noise_ratio, (list, tuple)), \
                "train noise_ratio must be a list (loader.py:587)"

    def sample_bg_pcds(self, sampled_classes, blacklist, n_bg_cls: int = 4,
                       per_bg: int = 1):
        """Background point clouds from classes outside the episode
        (loader.py:853-887).  The reference returns these with every train
        episode but the model never consumes them — exposed here as an
        opt-in API instead of dead per-episode work.

        Returns (pcds (n, num_point, attrs), masks (n, num_point))."""
        rng = self.rng
        bg_classes = [c for c in self.classes if c not in sampled_classes]
        n_bg_cls = min(n_bg_cls, len(bg_classes))
        feats, labels = [], []
        for _ in range(n_bg_cls):
            cls = int(rng.choice(bg_classes))
            bg_classes.remove(cls)
            cands = [s for s in self.class2scans[cls] if s not in blacklist]
            scan = rng.choice(cands, per_bg, replace=False)
            blacklist.extend(scan)
            pt, lb, _, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, scan,
                sampled_class=cls, sampled_classes=sampled_classes,
                is_support=True, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)
            feats.append(pt)
            labels.append(lb)
        return (np.concatenate(feats).astype(np.float32),
                np.concatenate(labels).astype(np.int32))

    def _episode(self, sampled_classes: np.ndarray) -> Episode:
        rng = self.rng
        if self.mode == "train":
            ratio = rng.choice(np.asarray(self.noise_ratio, np.float64))
        else:
            ratio = float(self.noise_ratio)
        num_noise = int(round(self.k_shot * ratio))

        # noise class range (loader.py:676-687)
        if self.mode == "test":
            if self.noise_type == "sym":
                noise_range = list(sampled_classes)
            elif self.noise_type == "ood":
                noise_range = [c for c in self.classes if c not in sampled_classes]
            elif self.noise_type in ("partial", "pair"):
                noise_range = None             # per-way (loader.py:734-737)
            else:
                raise NotImplementedError(
                    "only sym/ood/partial/pair noise implemented for meta-test")
        else:
            noise_range = list(self.classes)

        sup_x, sup_y, q_x, q_y = [], [], [], []
        gt_sup, gt_q, flags = [], [], []
        blacklist: list = []

        for cls in sampled_classes:
            cls = int(cls)
            names = [s for s in self.class2scans[cls] if s not in blacklist]
            pick = rng.choice(names, self.k_shot - num_noise + self.n_queries,
                              replace=False)
            blacklist.extend(pick)
            q_names = pick[:self.n_queries]
            clean_names = pick[self.n_queries:]

            sp, sl, sg, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, clean_names,
                sampled_class=cls, sampled_classes=sampled_classes,
                is_support=True, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)
            qp, ql, qg, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, q_names,
                sampled_class=cls, sampled_classes=sampled_classes,
                is_support=False, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)

            flag = np.zeros(self.k_shot)
            flag[:len(clean_names)] = cls

            if self.noise_type == "partial":
                way_range = [cls]
            elif self.noise_type == "pair":
                way_range = [int(self.noise_pair[int(cls)])]  # loader.py:734-735
            else:
                way_range = list(noise_range)
            for i in range(num_noise):
                # draw a wrong-class scan; masks pretend it's `cls`
                # (loader.py:741-792)
                if self.noise_type in ("partial", "pair"):
                    # pair partners may map a class to itself (the
                    # reference's commented dicts do) — no != cls loop
                    # (loader.py:744-745)
                    noisy_cls = int(rng.choice(way_range))
                else:
                    noisy_cls = cls
                    while noisy_cls == cls:
                        noisy_cls = int(rng.choice(way_range))
                cands = [s for s in self.class2scans[noisy_cls]
                         if s not in blacklist]
                scan = rng.choice(cands, 1, replace=False)
                if self.noise_type == "partial":
                    # require >=3 objects and >=3 classes (loader.py:755-763)
                    d = load_scan(self.data_path, scan[0])
                    while (len(np.unique(d[:, -1])) < 3
                           or len(np.unique(d[:, 6])) < 3):
                        scan = rng.choice(cands, 1, replace=False)
                        d = load_scan(self.data_path, scan[0])
                blacklist.extend(scan)
                npnt, nlab, ngt, _ = sample_k_scans(
                    self.data_path, self.num_point, self.pc_attribs, scan,
                    sampled_class=noisy_cls, sampled_classes=sampled_classes,
                    is_support=True, partial_noise=self.noise_type == "partial",
                    pc_augm=self.pc_augm, pc_augm_config=self.pc_augm_config,
                    rng=rng)
                sp = np.concatenate([sp, npnt]); sl = np.concatenate([sl, nlab])
                sg = np.concatenate([sg, ngt])
                flag[len(clean_names) + i] = noisy_cls
                # reference quirk (loader.py:742,787-790): its per-draw
                # counter dict resets every iteration, so a drawn class
                # leaves the range iff k_shot - num_noise - 1 == 1.  The
                # last-candidate guard is ours: where the reference would
                # hang (sym 2-way) or crash (exhausted ood range) on the
                # next draw, we keep the final non-cls candidate instead.
                if (self.noise_type not in ("partial", "pair")
                        and self.k_shot - num_noise - 1 == 1
                        and sum(1 for c in way_range if c != cls) > 1):
                    way_range.remove(noisy_cls)

            if num_noise > 0:
                sg[-num_noise:] = 0          # noisy shots' gt zeroed (loader.py:797-801)

            order = rng.permutation(self.k_shot)   # shot shuffle (loader.py:804-818)
            sup_x.append(sp[order]); sup_y.append(sl[order])
            gt_sup.append(sg[order]); flags.append(flag[order])
            q_x.append(qp); q_y.append(ql); gt_q.append(qg)

        return Episode(
            support_x=np.stack(sup_x).astype(np.float32),
            support_y=np.stack(sup_y).astype(np.int32),
            query_x=np.concatenate(q_x).astype(np.float32),
            query_y=np.concatenate(q_y).astype(np.int32),
            gt_support_y=np.stack(gt_sup).astype(np.int32),
            gt_query_y=np.concatenate(gt_q).astype(np.int32),
            support_flag=np.stack(flags).astype(np.int32),
            sampled_classes=sampled_classes.astype(np.int32),
        )

    # ------------------------------------------------------------------
    def sample_augmented(self, n_way_classes: Optional[Sequence[int]] = None,
                         *, n_bg_cls: int = 4, per_bg: int = 3):
        """Episode plus self-supervised auxiliary views
        (`generate_one_episode_Augment`, loader.py:892-1188).

        Beyond the regular noisy episode, every support shot (clean and
        noisy) and a handful of background clouds contribute two extra
        views drawn from the same scans:

          * a fresh 1024-point subsample (independent point choice and
            augmentation draw, loader.py:966-977,1044-1057);
          * a segment-cutout view of the 2048-point cloud: the largest
            foreground segment is zeroed in both coordinates and mask
            (`cut_out`, loader.py:1191-1238).

        Returns ``(episode, aux)`` with
        ``aux = {pcd_1024 (n,1024,a), label_1024 (n,1024),
        pcd_cutout (n,num_point,a), label_cutout (n,num_point)}`` where
        ``n = n_way*k_shot + n_bg_cls*per_bg`` and the rows are ordered
        way-by-way clean-then-noisy (pre-shuffle), then background — the
        reference's aggregation order.  Supported noise types match the
        reference's branch (sym/ood/pair at meta-test, 'train' range at
        meta-train; loader.py:926-934,1005-1014)."""
        rng = self.rng
        if n_way_classes is not None:
            sampled_classes = np.asarray(n_way_classes)
        else:
            sampled_classes = rng.choice(self.classes, self.n_way,
                                         replace=False)
        if self.mode == "train":
            ratio = rng.choice(np.asarray(self.noise_ratio, np.float64))
        else:
            ratio = float(self.noise_ratio)
        num_noise = int(round(self.k_shot * ratio))

        if self.mode == "test":
            if self.noise_type == "sym":
                noise_range = list(sampled_classes)
            elif self.noise_type == "ood":
                noise_range = [c for c in self.classes
                               if c not in sampled_classes]
            elif self.noise_type == "pair":
                noise_range = None             # per-way (loader.py:1005-1006)
            else:
                raise NotImplementedError(
                    "augmented episodes implement sym/ood/pair meta-test "
                    "noise (loader.py:927-934,1005-1014)")
        else:
            noise_range = list(self.classes)

        sup_x, sup_y, q_x, q_y = [], [], [], []
        gt_sup, gt_q, flags = [], [], []
        pcd_1024, label_1024 = [], []
        pcd_co, label_co, cluster_co = [], [], []
        blacklist: list = []

        def _sample(names, cls, npts, *, want_cluster=False):
            pt, lb, gt, cl = sample_k_scans(
                self.data_path, npts, self.pc_attribs, names,
                sampled_class=cls, sampled_classes=sampled_classes,
                is_support=True, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)
            return (pt, lb, gt, cl) if want_cluster else (pt, lb, gt)

        for cls in sampled_classes:
            cls = int(cls)
            names = [s for s in self.class2scans[cls] if s not in blacklist]
            pick = rng.choice(names, self.k_shot - num_noise + self.n_queries,
                              replace=False)
            blacklist.extend(pick)
            q_names = pick[:self.n_queries]
            clean_names = pick[self.n_queries:]

            sp, sl, sg, sc = _sample(clean_names, cls, self.num_point,
                                     want_cluster=True)
            p1, l1, _ = _sample(clean_names, cls, 1024)
            pcd_1024.append(p1); label_1024.append(l1)
            pcd_co.append(sp); label_co.append(sl); cluster_co.append(sc)

            qp, ql, qg, _ = sample_k_scans(
                self.data_path, self.num_point, self.pc_attribs, q_names,
                sampled_class=cls, sampled_classes=sampled_classes,
                is_support=False, pc_augm=self.pc_augm,
                pc_augm_config=self.pc_augm_config, rng=rng)

            flag = np.zeros(self.k_shot)
            flag[:len(clean_names)] = cls

            way_range = ([int(self.noise_pair[int(cls)])]
                         if self.noise_type == "pair"
                         else list(noise_range))
            noisy_cls = cls
            for i in range(num_noise):
                if self.noise_type == "pair":  # partner may equal cls
                    noisy_cls = int(rng.choice(way_range))
                else:
                    noisy_cls = cls
                    while noisy_cls == cls:
                        noisy_cls = int(rng.choice(way_range))
                cands = [s for s in self.class2scans[noisy_cls]
                         if s not in blacklist]
                scan = rng.choice(cands, 1, replace=False)
                blacklist.extend(scan)
                npnt, nlab, ngt, ncl = _sample(scan, noisy_cls,
                                               self.num_point,
                                               want_cluster=True)
                sp = np.concatenate([sp, npnt])
                sl = np.concatenate([sl, nlab])
                sg = np.concatenate([sg, ngt])
                p1, l1, _ = _sample(scan, noisy_cls, 1024)
                pcd_1024.append(p1); label_1024.append(l1)
                pcd_co.append(npnt); label_co.append(nlab)
                cluster_co.append(ncl)
                flag[len(clean_names) + i] = noisy_cls
                # reference quirk: its per-draw counter dict resets every
                # iteration, so a drawn class is dropped from the range
                # iff k_shot - num_noise - 1 == 1 (loader.py:1011,1065-1068).
                # Last-candidate guard as in _episode: never empty the range.
                if (self.noise_type != "pair"
                        and self.k_shot - num_noise - 1 == 1
                        and sum(1 for c in way_range if c != cls) > 1):
                    way_range.remove(noisy_cls)

            if num_noise > 0 and noisy_cls != cls:
                sg[-num_noise:] = 0          # loader.py:1075-1076

            order = rng.permutation(self.k_shot)  # loader.py:1079-1081
            sup_x.append(sp[order]); sup_y.append(sl[order])
            gt_sup.append(sg[order]); flags.append(flag[order])
            q_x.append(qp); q_y.append(ql); gt_q.append(qg)

        # background clouds: n_bg_cls distinct classes drawn from the FULL
        # class list (the reference does not exclude the episode's ways,
        # loader.py:1133-1136), per_bg scans each, both views
        bg_list = [c for c in self.classes]
        for _ in range(min(n_bg_cls, len(bg_list))):
            bg_cls = int(rng.choice(bg_list))
            bg_list.remove(bg_cls)
            cands = [s for s in self.class2scans[bg_cls]
                     if s not in blacklist]
            scans = rng.choice(cands, per_bg, replace=False)
            blacklist.extend(scans)
            bp, bl, _, bc = _sample(scans, bg_cls, self.num_point,
                                    want_cluster=True)
            pcd_co.append(bp); label_co.append(bl); cluster_co.append(bc)
            p1, l1, _ = _sample(scans, bg_cls, 1024)
            pcd_1024.append(p1); label_1024.append(l1)

        cut_x, cut_y = cut_out(np.concatenate(pcd_co),
                               np.concatenate(label_co),
                               np.concatenate(cluster_co))
        aux = {
            "pcd_1024": np.concatenate(pcd_1024).astype(np.float32),
            "label_1024": np.concatenate(label_1024).astype(np.int32),
            "pcd_cutout": cut_x.astype(np.float32),
            "label_cutout": cut_y.astype(np.int32),
        }
        episode = Episode(
            support_x=np.stack(sup_x).astype(np.float32),
            support_y=np.stack(sup_y).astype(np.int32),
            query_x=np.concatenate(q_x).astype(np.float32),
            query_y=np.concatenate(q_y).astype(np.int32),
            gt_support_y=np.stack(gt_sup).astype(np.int32),
            gt_query_y=np.concatenate(gt_q).astype(np.int32),
            support_flag=np.stack(flags).astype(np.int32),
            sampled_classes=sampled_classes.astype(np.int32),
        )
        return episode, aux


def cut_out(pcd: np.ndarray, label: np.ndarray, cluster: np.ndarray):
    """Segment-cutout corruption (`NoiseInMetaTest.cut_out`,
    loader.py:1191-1238): per cloud, find the largest foreground segment
    (mode of the cluster column over label==1 points) and, when the cloud
    has more than one fg segment, zero that segment's attributes and mask.

    pcd (n, p, a) float, label (n, p) int, cluster (n, p) int →
    (pcd', label') copies."""
    out_x = pcd.copy()
    out_y = label.copy()
    for i in range(pcd.shape[0]):
        seg_ids, seg_counts = np.unique(cluster[i][label[i] == 1],
                                        return_counts=True)
        if len(seg_ids) > 1:
            target = seg_ids[np.argmax(seg_counts)]
            m = cluster[i] == target
            out_y[i][m] = 0
            out_x[i][m, :] = 0.0
    return out_x, out_y
